"""The benchmark's general part: find a cell by name, run it once, print its result.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``: a
configuration and a traffic mix. Everything particular to one of them
lives in files of its own, found by name:

- the configuration: the ``file`` its ``configs`` entry names (sizes,
  dtypes, its source), under ``bench/configs/``;
- the traffic mix: ``bench/traffic/<traffic>.json``, whose ``loop``
  names the loop that serves it (``bench/loops/<loop>.py``) and
  whose other keys are that loop's parameters (lengths, steps, orders,
  seeds of the check, the limits of the comparison);
- each metric: ``bench/metrics/<metric>.py``, else the reader its name
  before the first dot names (``step_mfu.train`` is read by
  ``step_mfu.py``), whose ``read(run)`` takes the number from the run's
  host clock, counters or trace, and returns None where it finds nothing
  to read.

The harness knows no cell. It runs: set-up (the loop builds the
program and its inputs from the seed and warms every shape the traffic
uses), the window (the loop serves the traffic for ``--seconds``; with
``--trace 1`` one window without the profiler, for the per-layer metrics
read by the host's clock, then one under it, for the others), the
device's peak memory, the release
of the program's state, the comparison with the plain reference, and
the result: the last line of standard output, one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that must not be loaded in a run: the JAX package
# and JAX itself (``repro_torch`` is another name)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    """One resolved cell: its names, its configuration and traffic (the
    files' contents), its chips, and the metrics it reports."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` on standard error after the seconds since the harness was
    loaded: where a run's set-up and checks spend their time."""
    print(f"bench {time.perf_counter() - _T0:8.2f} s  {msg}", file=sys.stderr, flush=True)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _reports(entry: dict, cell: str, e2e_names: set[str]) -> bool:
    """Whether ``cell`` reports the metric ``entry``: the cells its
    ``workloads`` lists; without that key, an end-to-end metric (as
    ``setup_s``) every cell, and a per-layer metric every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry["moves"] in e2e_names if "moves" in entry else True


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s BENCHMARK.json, its
    configuration and traffic read from their files. Raises KeyError for
    an unknown name, FileNotFoundError for a missing file."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, workload, names)]
    return Cell(workload, config, traffic, w["chips"], e2e, per_layer)


def metric_reader(name: str, root: Path = ROOT):
    """The module ``bench/metrics/<name>.py``, else the one of ``name``'s
    part before its first dot (loaded by its path: a metric's name may
    hold dots)."""
    path = root / "bench" / "metrics" / f"{name}.py"
    if not path.is_file():
        path = path.with_name(f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{path.stem}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(name: str):
    return importlib.import_module(f"bench.loops.{name}")


@dataclass
class Unit:
    """One served unit of work (a job, a step, a request): its host-clock
    start and end (perf_counter seconds) and what it did."""
    start: float
    end: float
    work: dict = field(default_factory=dict)


@dataclass
class Run:
    """What the metric readers see of one run."""
    cell: Cell
    units: list[Unit]
    window_s: float
    setup_s: float
    trace: object = None              # devtrace.Trace of the window, --trace 1
    launches: dict = field(default_factory=dict)
    peak_window_bytes: int = 0

    def total(self, key: str) -> float:
        return sum(u.work.get(key, 0) for u in self.units)

    def mfu_pct(self, dtype: str):
        """The window's model operations over its seconds, as a share of
        the peak of ``dtype``."""
        from bench import work

        flops = self.total("flops")
        if not flops or self.window_s <= 0:
            return None
        return 100.0 * flops / self.window_s / work.PEAK_FLOP_PER_S[dtype]

    def idle_pct(self):
        if self.trace is None or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_s() / self.trace.window_s)


@dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct where every value is finite and at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them ("" if
    it cannot)."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _window(drv, cell: Cell, seconds: float, setup_s: float, device, prof=None) -> Run:
    """One window of ``seconds`` served by ``drv``, under ``prof`` where
    given: its units, the program's launches, its trace and the device's
    peak in it."""
    import torch
    from repro_torch.kernels import _build

    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    _build.reset_launches()
    if prof is not None:
        prof.__enter__()
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    units = drv.window(seconds)
    t1 = time.perf_counter()
    t1_ns = time.time_ns()
    launches = {name: dict(counts) for name, counts in (
        ("LAUNCHES", _build.LAUNCHES),
        ("FLASH_DESIGN_LAUNCHES", _build.FLASH_DESIGN_LAUNCHES),
        ("FLASH_BWD_DESIGN_LAUNCHES", _build.FLASH_BWD_DESIGN_LAUNCHES),
        ("STENCIL_DESIGN_LAUNCHES", _build.STENCIL_DESIGN_LAUNCHES),
        ("BLOCKS_DESIGN_LAUNCHES", _build.BLOCKS_DESIGN_LAUNCHES))}
    log(f"window{' (traced)' if prof else ''}: {len(units)} units in {t1 - t0:.3f} s")
    tr = None
    if prof is not None:
        from bench.devtrace import Trace

        prof.__exit__(None, None, None)
        log("trace: profiler stopped")
        tr = Trace.of(prof, t0_ns, t1_ns)
        log(f"trace: {len(tr.device)} device and {len(tr.host)} host events read")
    # a loop that keeps state of its own in the window for its check (the
    # training loop's snapshot) reads the program's peak before taking it
    peak = getattr(drv, "program_peak", None)
    if peak is None:
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    window_s = (units[-1].end - t0) if units else (t1 - t0)
    return Run(cell, units, window_s, setup_s, tr, launches, peak)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """Set up, serve the window, release, compare: the result's fields,
    and the loop (which serves the control after its check). With
    ``trace``, ``plain`` is a window served first without the profiler,
    whose host cost would slow a cell that the host paces: the per-layer
    metrics read by the host's clock come from it."""
    import torch

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    drv = loop_module(cell.loop).Loop(cell, seed, device, sync)
    log(f"set-up of {cell.name}, seed {seed}")
    drv.setup()
    sync()
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    setup_s = time.perf_counter() - t_start
    plain = None
    if trace and any(m["source"] == "host_clock" for m in cell.per_layer):
        plain = _window(drv, cell, seconds, setup_s, device)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
    run = _window(drv, cell, seconds, setup_s, device, prof)
    del prof
    peak = max(setup_peak, run.peak_window_bytes,
               plain.peak_window_bytes if plain else 0)
    drv.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = drv.check()
    log("reference compared")
    return dict(run=run, plain=plain or run, checks=checks, peak=peak,
                expect=drv.expected_designs(run.launches), loop=drv)


def is_correct(out: dict) -> bool:
    """Whether a run of :func:`run_cell` is correct: every number compared
    within its limit. (A unit that fails raises, and the run prints no
    result.)"""
    return bool(out["checks"]) and all(c.ok for c in out["checks"])


def read_metrics(out: dict, trace: bool) -> dict:
    """The end-to-end metrics, or with ``trace`` the per-layer ones: each
    read from the traced window, those of the host's clock from the
    window without the profiler."""
    run = out["run"]
    entries = run.cell.per_layer if trace else run.cell.end_to_end
    metrics = {}
    for m in entries:
        if m["name"] == "setup_s":
            value = run.setup_s
        else:
            src = out["plain"] if m["source"] == "host_clock" else run
            value = metric_reader(m["name"]).read(src)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def _number(x: float):
    """``x``, or its name where it is not finite (JSON has no infinity)."""
    return x if math.isfinite(x) else str(x)


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    import torch

    cell = resolve(args.workload)
    log("torch loaded")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: cell {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    log(f"CUDA up on {torch.cuda.get_device_name(device)}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
    run, plain, checks = out["run"], out["plain"], out["checks"]
    bad = forbidden_loaded()
    if bad:
        print(f"bench: the run loaded {bad}; nothing of JAX or the JAX "
              f"package may run", file=sys.stderr)
        return 3
    metrics = read_metrics(out, bool(args.trace))
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips, "memory_peak_bytes": int(out["peak"])}
    served = [run] if plain is run else [plain, run]
    result = {"correct": is_correct(out), "attempted": sum(len(r.units) for r in served),
              "failed": 0, "metrics": metrics, "device": device_info}
    info = {"card": power_limit(), "units": [len(r.units) for r in served],
            "window_s": [r.window_s for r in served], "setup_s": run.setup_s,
            "launches": run.launches, "designs": out["expect"]}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit}
                        for c in checks}
    print("bench info " + json.dumps(info), flush=True)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
