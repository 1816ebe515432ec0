"""The dry run (``repro_torch.launch.dryrun``) against the JAX package's:
the registry's dry-run half, the abstract trees, the mini cells of
tests/test_dryrun_mini.py and the CLI.

The mini cells are the SMOKE configs of five archs on a (2, 4) ("data",
"model") mesh of torch's fake process group, on the meta device: a train
cell and a decode cell of S=64, B=8. Held exactly against the JAX
package's (the ``dryrun`` recipe of tests/_torch_oracle.py): ``n_params``,
``n_active``, ``model_flops_global`` and the argument bytes per device.
Both packages' cells run in child processes (``port_dryrun`` two, the
recipe one), started with the module, while the other tests run here:
DTensor's sharding propagation takes seconds for each new product on the
CPU.
The flops, bytes and collective bytes are not compared: XLA fuses and
schedules its own partitioning, eager DTensor does neither. Two
invariants of the count are held exactly instead: the count on CPU
tensors equals the count on meta, and on a pure-data (8, 1) mesh a
prefill's matmul flops times 8 equal the unsharded count.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from _torch_oracle import (DRYRUN_ARCHS, DRYRUN_BATCH, DRYRUN_MESH, DRYRUN_SEQ,
                           port_dryrun_started, recipe_started)
from repro.configs import registry as jreg
from repro.models import build_model as jbuild
from repro_torch.configs import registry as reg
from repro_torch.launch import dryrun
from repro_torch.models import Model
from repro_torch.models.params import leaf_paths
from repro_torch.roofline import op_cost

TRAIN = reg.ShapeSpec("mini_train", DRYRUN_SEQ, DRYRUN_BATCH, "train")
DECODE = reg.ShapeSpec("mini_decode", DRYRUN_SEQ, DRYRUN_BATCH, "decode")
PREFILL = reg.ShapeSpec("mini_prefill", DRYRUN_SEQ, DRYRUN_BATCH, "prefill")
# the equal-count check's fields: what the card check compares too
COUNT_KEYS = ("flops_per_dev", "bytes_per_dev", "coll_bytes", "flops_by_kind")


# the port's mini cells in two children of about equal length
PORT_SPLIT = (("deepseek-moe-16b", "mamba2-2.7b"),
              ("zamba2-1.2b", "smollm-360m", "gemma3-1b"))


def _once(wait):
    out = {}

    def get():
        if not out:
            out.update(wait())
        return out
    return get


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The JAX recipe and the port's cells, started with the module and
    waited for where a test first reads them."""
    ref = _once(recipe_started(tmp_path_factory.mktemp("ref_dryrun"), "dryrun"))
    ports = [port_dryrun_started(tmp_path_factory.mktemp("port_dryrun"), archs)
             for archs in PORT_SPLIT]
    port = _once(lambda: {k: v for w in ports for k, v in w().items()})
    return ref, port


@pytest.fixture(autouse=True)
def _started(children):
    """Start the children before the first test."""


# ------------------------------------------------------------ the CLI
# first, before the module's process group exists: main makes its own
def test_main_writes_a_record(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh",
                 "single", "--out", str(tmp_path)])
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "smollm-360m_decode_32k_single_pod_16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256 and rec["device"] == "meta"
    assert rec["collective_link"] == "internode"
    assert rec["model_flops_global"] == 2.0 * rec["n_active"] * 128
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["memory_per_device"]["argument_bytes"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    out = capsys.readouterr().out
    assert "roofline:" in out and "all 1 cells counted OK" in out


def test_main_skips_and_reports_failures(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k", "--out",
                 str(tmp_path)])
    assert "SKIP smollm-360m × long_500k" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out",
                     str(tmp_path), "--opt", "flash=1"])
    assert e.value.code == 1 and not dist.is_initialized()
    assert "1 FAILURES" in capsys.readouterr().out
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("opt", ["donate=0", "window_cache=1", "flsh=1"])
def test_main_refuses_an_option_it_does_not_read(tmp_path, capsys, opt):
    """The JAX package's ``donate`` and ``window_cache`` change nothing in
    an eager step: ``--opt`` refuses them, as any name it does not read."""
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--out",
                     str(tmp_path), "--opt", opt])
    assert e.value.code == 2 and not dist.is_initialized()
    assert "not an option of the dry run" in capsys.readouterr().err
    assert set(dryrun.DEFAULT_OPTS) == {"act_seq_shard", "remat", "microbatches",
                                        "score_shard", "flash", "device_order"}


# ------------------------------------------------ the registry's half
def test_registry_dry_run_half_equals_jax():
    assert reg.LONG_OK == jreg.LONG_OK
    assert reg.cells() == jreg.cells()
    assert reg.cells(include_skipped=True) == jreg.cells(include_skipped=True)
    for arch in reg.ARCHS:
        for s in reg.SHAPES:
            assert reg.shape_skip_reason(arch, s) == jreg.shape_skip_reason(arch, s)
    assert sorted(reg.__all__) == sorted(jreg.__all__)


@pytest.mark.parametrize("arch", reg.ARCHS)
def test_input_specs_equal_jax(arch):
    cfg, jcfg = reg.get_config(arch), jreg.get_config(arch)
    for name, shape in reg.SHAPES.items():
        for bo in (None, 2):
            got = reg.input_specs(cfg, shape, batch_override=bo)
            want = jreg.input_specs(jcfg, jreg.SHAPES[name], batch_override=bo)
            assert list(got) == list(want)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (arch, name, k)
                assert str(t.dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", reg.ARCHS)
def test_abstract_trees_equal_jax(arch):
    """``Model.abstract`` and ``abstract_cache`` at full width on meta:
    nothing allocated, the JAX package's shapes and dtypes leaf for leaf."""
    cfg = reg.get_config(arch)
    m, jm = Model(cfg, device="meta"), jbuild(jreg.get_config(arch))
    for got, want in ((m.abstract(torch.bfloat16), jm.abstract(jnp.bfloat16)),
                      (m.abstract_cache(8, 4096, torch.float32),
                       jm.abstract_cache(8, 4096, jnp.float32))):
        flat = dict(leaf_paths(got))
        jflat = {tuple(getattr(k, "key", k) for k in path): leaf for path, leaf
                 in jax.tree_util.tree_flatten_with_path(want)[0]}
        assert set(flat) == set(jflat)
        for path, t in flat.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(jflat[path].shape), (arch, path)
            assert str(t.dtype).split(".")[-1] == str(jflat[path].dtype)
    assert all(p.device.type == "meta" for p in m.parameters())


@pytest.mark.parametrize("arch", reg.ARCHS)
def test_meta_model_runs_every_entry_point(arch):
    """A meta model, unsharded: loss (and its gradient), prefill and
    decode give the shapes the CPU gives."""
    cfg = reg.get_smoke(arch)
    m = Model(cfg, device="meta").requires_grad_()
    batch = reg.input_specs(cfg, PREFILL)
    loss, _ = m.loss(batch)
    assert loss.shape == () and loss.device.type == "meta"
    grads = torch.autograd.grad(loss, list(m.parameters()))
    assert all(g.shape == p.shape for g, p in zip(grads, m.parameters()))
    assert tuple(m.prefill(batch).shape) == (DRYRUN_BATCH, cfg.vocab_padded)
    cache = m.init_cache(DRYRUN_BATCH, DRYRUN_SEQ)
    tokens = reg.input_specs(cfg, DECODE)["tokens"]
    logits, _ = m.decode(cache, {"tokens": tokens, "cur": 3})
    assert tuple(logits.shape) == (DRYRUN_BATCH, 1, cfg.vocab_padded)


def test_model_still_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        Model(reg.get_smoke("smollm-360m"))
    with pytest.raises(RuntimeError, match="cuda"):
        reg.concrete_batch(reg.get_smoke("smollm-360m"), TRAIN)


# ---------------------------------------------------------- the mesh
@pytest.fixture(scope="module")
def group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(8).reshape(shape),
                      mesh_dim_names=("data", "model"))


def test_flash_has_no_meta_form(group):
    with pytest.raises(ValueError, match="no meta form"):
        dryrun.run_cell(reg.get_smoke("smollm-360m"), PREFILL, _mesh(DRYRUN_MESH),
                        "mini", {**dryrun.DEFAULT_OPTS, "flash": 1})


@pytest.mark.parametrize("arch,shape", [("deepseek-moe-16b", DECODE),
                                        ("zamba2-1.2b", DECODE),
                                        ("gemma3-1b", TRAIN)],
                         ids=["moe-decode", "hybrid-decode", "dense-train"])
def test_cpu_count_equals_meta(group, arch, shape):
    """Mini cells on CPU tensors (seeded weights and inputs, the fake
    group's collectives moving nothing): the count on meta, exactly. The
    MoE dispatch, the Mamba2 layers beside a shared attention block, a
    backward through remat; smollm-360m is held so on the card
    (chip_smoke.py)."""
    got = {d: dryrun.run_cell(reg.get_smoke(arch), shape, _mesh(DRYRUN_MESH),
                              "mini", dryrun.DEFAULT_OPTS, device=d)
           for d in ("meta", "cpu")}
    for k in COUNT_KEYS:
        assert got["cpu"][k] == got["meta"][k], k
    assert got["cpu"]["memory_per_device"]["argument_bytes"] == \
        got["meta"]["memory_per_device"]["argument_bytes"]


@pytest.mark.parametrize("arch", ["smollm-360m", "deepseek-moe-16b", "zamba2-1.2b"])
def test_pure_data_mesh_divides_the_matmuls(group, arch):
    """On an (8, 1) mesh every rank runs its own rows: its prefill's
    matmul flops are an eighth of the unsharded prefill's, exactly."""
    cfg = reg.get_smoke(arch)
    rec = dryrun.run_cell(cfg, PREFILL, _mesh((8, 1)), "data8", dryrun.DEFAULT_OPTS)
    m = Model(dataclasses.replace(cfg, param_dtype="bfloat16"), device="meta")
    with op_cost.count() as whole:
        m.prefill(reg.input_specs(cfg, PREFILL))
    assert 8 * rec["flops_by_kind"]["matmul"] == whole.flops_by_kind["matmul"]


@pytest.mark.parametrize("arch", DRYRUN_ARCHS)
def test_mini_cells_match_jax(children, arch):
    ref, port = children
    want, got = ref(), port()
    for mode in ("train", "decode"):
        rec = got[(arch, mode)]
        pre = f"{arch}/{mode}/"
        assert rec["n_params"] == int(want[pre + "n_params"])
        assert rec["n_active"] == int(want[pre + "n_active"])
        assert rec["model_flops_global"] == float(want[pre + "model_flops_global"])
        assert rec["memory_per_device"]["argument_bytes"] == \
            int(want[pre + "argument_bytes"]), (arch, mode)
        assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
        assert rec["n_devices"] == 8 and rec["coll_bytes"]
