"""What the benchmark loads, and how it finds a cell.

In a fresh interpreter: the harness, every loop and every metric
reader load neither JAX nor the JAX package (``repro``, compared by
whole top-level names: ``repro_torch`` is the port); the reference loads
neither, nor anything of the port. And a cell, a configuration, a
traffic mix and a metric added as new files (and entries in
BENCHMARK.json) are found by name, no file of the harness edited.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

_LOADED = """
import importlib, json, sys
sys.path[:0] = [{root!r}, {src!r}]
for name in {modules!r}:
    importlib.import_module(name)
{extra}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_after(modules, extra=""):
    code = _LOADED.format(root=str(ROOT), src=str(ROOT / "src"),
                          modules=list(modules), extra=extra)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_neither_jax_nor_the_jax_package():
    loops = [f"bench.loops.{p.stem}" for p in (ROOT / "bench/loops").glob("*.py")]
    readers = "\n".join(
        f"harness.metric_reader({p.name[:-3]!r})"
        for p in sorted((ROOT / "bench/metrics").glob("*.py")))
    loaded = _top_level_after(
        ["bench.harness", "bench.devtrace", "bench.work", "bench.faults",
         "repro_torch.stencil.pipeline", "repro_torch.models",
         "repro_torch.train", "repro_torch.data", *loops],
        "from bench import harness\n" + readers)
    assert "repro_torch" in loaded and "bench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}, loaded


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(["bench.reference.wave", "bench.reference.lm"])
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, loaded


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_add_a_cell_found_by_name(tmp_path):
    from bench import harness

    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path)
    # a configuration, a traffic mix and a per-layer metric, each a new file
    cfg = json.loads((ROOT / "bench/configs/wave-m256.json").read_text())
    (tmp_path / "bench/configs/wave-m128.json").write_text(
        json.dumps(dict(cfg, name="wave-m128", M=128)))
    traffic = json.loads((ROOT / "bench/traffic/hilbert.json").read_text())
    (tmp_path / "bench/traffic/morton.json").write_text(
        json.dumps(dict(traffic, block_order="morton")))
    (tmp_path / "bench/metrics/probe_ms.stencil.py").write_text(
        "def read(run):\n    return 1.5\n")
    # and their entries in BENCHMARK.json
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "wave-m128", "source": cfg["source"],
                            "file": "bench/configs/wave-m128.json", "reduced": ["M"],
                            "why": "probe"})
    spec["workloads"].append({"name": "wave-m128.morton", "config": "wave-m128",
                              "traffic": "morton", "chips": 1, "why": "probe"})
    for m in spec["end_to_end"]:
        if m["name"] == "stencil_glups":
            m["workloads"].append("wave-m128.morton")
    spec["per_layer"].append({"name": "probe_ms.stencil", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "pipeline", "moves": "stencil_glups",
                              "workloads": ["wave-m128.morton"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = harness.resolve("wave-m128.morton", root=tmp_path)
    assert cell.config["M"] == 128 and cell.traffic["block_order"] == "morton"
    assert cell.loop == "stencil_jobs"
    assert harness.loop_module(cell.loop).Loop
    assert [m["name"] for m in cell.end_to_end] == ["stencil_glups", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["probe_ms.stencil"]
    assert harness.metric_reader("probe_ms.stencil", root=tmp_path).read(None) == 1.5
    # the committed cells resolve as before, and no file there changed
    assert harness.resolve("wave-m256.hilbert", root=tmp_path).config["M"] == 256
    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"bench/configs/wave-m128.json",
                                        "bench/traffic/morton.json",
                                        "bench/metrics/probe_ms.stencil.py"}


def test_every_committed_cell_resolves_with_its_metrics():
    from bench import harness

    spec = harness.load_spec()
    for w in spec["workloads"]:
        cell = harness.resolve(w["name"])
        assert harness.loop_module(cell.loop).Loop
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert hasattr(harness.metric_reader(m["name"]), "read")
        for m in cell.end_to_end:
            if m["name"] != "setup_s":
                assert hasattr(harness.metric_reader(m["name"]), "read")
