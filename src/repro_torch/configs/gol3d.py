"""gol3d application configs (the paper's own experiment grid).

Paper §4: problem sizes M ∈ {64, 128, 256}, stencil g ∈ {1..4},
orderings ∈ {row-major, Morton, Hilbert}, halo widths {1, 2}.

``CHIP_*`` are the main paths ``chip_smoke.py`` drives on the card: the
resident path at the paper's largest size under each of the four element
orderings (the paper's three plus column-major), the repack path, and
the distributed path: the ``CHIP_MAIN`` grid decomposed over each mesh of
``CHIP_MESHES`` (1×1×1: one M=256 shard; 2×2×2: eight M=128 shards, all
held by one process on one card).

``CHIP_ROI_*`` size the ROI-query service's phase: the ``CHIP_MAIN`` run's
store (M=256, 32,768 blocks of 8³ f32, 64 MiB) served under each of the
four orderings, queried with :func:`roi_suite` (the JAX package's
benchmark suite, ``benchmarks/roi.py``, copied here: the port imports
nothing from ``benchmarks/``).
"""

import dataclasses

from repro_torch.core.orderings import COLUMN_MAJOR, HILBERT, MORTON, ROW_MAJOR
from repro_torch.serve.roi import ROI
from repro_torch.stencil.gol3d import Gol3dConfig

ORDERINGS = (ROW_MAJOR, MORTON, HILBERT)
PROBLEM_SIZES = (64, 128, 256)
STENCILS = (1, 2, 3, 4)
HALO_WIDTHS = (1, 2)

CONFIG = Gol3dConfig(M=64, g=1, ordering=MORTON, block_T=8)
SMOKE = Gol3dConfig(M=16, g=1, ordering=MORTON, block_T=4)

CHIP_ORDERINGS = (ROW_MAJOR, COLUMN_MAJOR, MORTON, HILBERT)
CHIP_MAIN = Gol3dConfig(M=256, g=1, ordering=HILBERT, block_T=8, substeps=4,
                        seed=1)
CHIP_MAIN_STEPS = 16
CHIP_REPACK = Gol3dConfig(M=128, g=1, ordering=HILBERT, block_T=8, seed=3)
CHIP_REPACK_STEPS = 2
CHIP_DISTRIBUTED = dataclasses.replace(CHIP_MAIN, seed=5)
CHIP_DISTRIBUTED_STEPS = 16
CHIP_MESHES = ((1, 1, 1), (2, 2, 2))

# the ROI-query service on the card: the snapshot of CHIP_MAIN after
# CHIP_MAIN_STEPS, each ordering's service holding every block in its cache
# (the warm queries hit), a deadline no query of the suite comes near, and
# the median of CHIP_ROI_REPS queries per reading
CHIP_ROI = CHIP_MAIN
CHIP_ROI_STEPS = CHIP_MAIN_STEPS
CHIP_ROI_CACHE_BLOCKS = (CHIP_MAIN.M // CHIP_MAIN.block_T) ** 3
CHIP_ROI_DEADLINE_S = 60.0
CHIP_ROI_REPS = 5
# the fault matrix at M=256: injected failures and a bit flip (the CLI's
# plan), a fetch slower than the deadline, and load shed above one query
CHIP_ROI_FAULTS = dict(fail_first=2, bitflip_first=1)
CHIP_ROI_SLOW_DEADLINE_S = 0.05
CHIP_ROI_SLOW_S = 0.1
CHIP_ROI_MAX_IN_FLIGHT = 1


def roi_suite(M: int) -> list[tuple[str, ROI]]:
    """The ROI suite of the JAX package's benchmark (``benchmarks/roi.py``
    ``roi_suite``): aligned power-of-two boxes, where the curve moves the
    range count (an aligned 2^a block cube is one octree subtree, one range
    on any bit-hierarchical curve), and one unaligned ``viewport`` whose
    edge blocks carry waste. Hilbert needs strictly fewer ranges than
    row-major on every entry at T=8 for M >= 32."""
    h = M // 2
    return [
        ("octant", ROI((0, 0, 0), (h, h, h))),
        ("octant_hi", ROI((h, h, h), (M, M, M))),
        ("slab", ROI((0, 0, 0), (M, h, h))),
        ("tile", ROI((0, h, 0), (h, M, h))),
        ("viewport", ROI((3, 5, 2), (h + 3, h + 5, h + 2))),
    ]
