"""gol3d application configs (the paper's own experiment grid).

Paper §4: problem sizes M ∈ {64, 128, 256}, stencil g ∈ {1..4},
orderings ∈ {row-major, Morton, Hilbert}, halo widths {1, 2}.

``CHIP_*`` are the main paths ``chip_smoke.py`` drives on the card: the
resident path at the paper's largest size under each of the four element
orderings (the paper's three plus column-major), and the repack path.
"""

from repro_torch.core.orderings import COLUMN_MAJOR, HILBERT, MORTON, ROW_MAJOR
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
