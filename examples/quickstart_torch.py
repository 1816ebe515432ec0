"""Quickstart on the torch port: the paper's pipeline in five minutes.

The twin of ``examples/quickstart.py`` on ``repro_torch``, on the card
unless ``--device cpu``:

1. Build Morton/Hilbert orderings of a data cube.
2. Reproduce the paper's offset histogram + cache-model results.
3. Run gol3d under each ordering and check they agree (the repack step,
   DESIGN.md §3: the ``stencil_sum_blocks`` kernel on the card).
4. Pack halo surfaces from SFC storage (the paper's §3.2 experiment; the
   ``gather_rows`` kernel on the card).

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import HILBERT, MORTON, ROW_MAJOR, apply_ordering
from repro_torch.core.cache_model import (cache_misses, offset_summary,
                                          surface_cache_misses)
from repro_torch.core.device import resolve_device
from repro_torch.core.surfaces import PAPER_SURFACE_NAMES, run_stats
from repro_torch.kernels.ops import pack_surface
from repro_torch.stencil import Gol3d, Gol3dConfig

ORDERINGS = (ROW_MAJOR, MORTON, HILBERT)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    M, g = 32, 1
    res = {"offsets": {}, "cache": {}, "pack": {}, "packed": {}}
    print("== 1. offset histograms (paper Figs 5-7) ==")
    for spec in ORDERINGS:
        s = offset_summary(spec, M, g)
        res["offsets"][spec.name] = (s.n_distinct, s.frac_within_line)
        print(f"  {spec.name:10s} distinct offsets {s.n_distinct:6d}  "
              f"within-64-line fraction {s.frac_within_line:.3f}")

    print("== 2. cache model (Alg. 1) ==")
    for spec in ORDERINGS:
        m = cache_misses(spec, M, g, b=8, c=64)
        sr = surface_cache_misses(spec, M, g, 8, 64, "j0")
        res["cache"][spec.name] = (m, sr)
        print(f"  {spec.name:10s} interior misses {m:7d}   sr-face misses {sr:5d}")

    print("== 3. gol3d under the three orderings (results must agree) ==")
    finals = {}
    for spec in ORDERINGS:
        app = Gol3d(Gol3dConfig(M=16, g=1, ordering=spec, block_T=4, seed=1,
                                device=str(dev)))
        app.run(5)
        finals[spec.name] = app.cube
    ref = finals["row_major"]
    for k, v in finals.items():
        ok = torch.equal(ref, v)
        print(f"  {k:10s} matches row-major result: {ok}")
        if not ok:
            raise RuntimeError(f"gol3d under {k} differs from row-major")
    res["finals"] = finals

    print("== 4. surface packing from SFC storage (paper §3.2) ==")
    rng = np.random.default_rng(0)
    cube = torch.from_numpy(rng.random((M, M, M)).astype(np.float32)).to(dev)
    for spec in ORDERINGS:
        data = apply_ordering(cube, spec)
        buf = pack_surface(data, spec, M, g, "j0")
        rs = run_stats(spec, M, g, "j0")
        res["pack"][spec.name] = (buf.shape[0], rs.n_runs, rs.mean_run)
        res["packed"][spec.name] = buf
        print(f"  {spec.name:10s} packed {buf.shape[0]:5d} items of the "
              f"{PAPER_SURFACE_NAMES['j0']} face in {rs.n_runs:4d} contiguous "
              f"runs (mean run {rs.mean_run:.1f})")
    print("done.")
    return res


if __name__ == "__main__":
    main()
