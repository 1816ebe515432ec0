"""Readings that set and test the limits of a cell's comparison, on the card.

    python3 bench/controls.py --workload <cell> --seeds 1,2,3 \
        [--mode sound|control|<fault>] [--seconds 2]

For every seed, one process runs the cell as ``bench/run.py`` does (a
short window), then prints one JSON line with what the comparison read:
``sound`` the program as it is (the lower readings), ``control`` the
same and then the control in the program's place (the upper readings:
the program's own lower-precision path, or the reference in a lower
precision), a fault of ``bench/faults.py`` the program with that fault
planted. The benchmark's own runs never run this.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "bench"]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402

import torch  # noqa: E402

from bench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.resolve(args.workload)
    dev = torch.device("cuda", 0)
    fault = args.mode not in ("sound", "control")
    if fault and args.mode not in faults.FAULTS[cell.loop]:
        raise SystemExit(f"{args.mode} is no fault of {cell.loop}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        with getattr(faults, args.mode)() if fault else contextlib.nullcontext():
            out = harness.run_cell(cell, seed, args.seconds, False, dev, t)
        line = {"workload": cell.name, "seed": seed, "mode": args.mode,
                "units": len(out["run"].units),
                "readings": {c.name: c.value for c in out["checks"]},
                "correct": harness.is_correct(out)}
        if args.mode == "control":
            line["control"] = {c.name: c.value for c in out["loop"].control()}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
