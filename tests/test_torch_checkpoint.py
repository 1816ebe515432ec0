"""The torch package's checkpoint store (repro_torch.checkpoint.ckpt): the
storage fault matrix of tests/test_resilience.py (dangling tmp and
manifest-less dirs skipped, truncated and bit-flipped chunks falling back
and quarantined, an explicit corrupt step raising, ``verify=False``, retry
on a transient OSError, ``keep``), leaves as tensors and arrays of every
dtype, the checkpoint byte models against the JAX package's, and
checkpoints crossing packages: the JAX package, in the reference child
process (tests/_torch_oracle.py, recipe ``ckpt``), writes a checkpoint
that this package restores and restores the one this package wrote, bit
for bit, with the same manifest keys.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_oracle import (CKPT_DTYPES, CKPT_META, CKPT_STEP, bits, ckpt_tree,
                           recipe_arrays)
from repro.stencil import pipeline as jpipe
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import CheckpointCorruptError
from repro_torch.launch.faults import (bitflip_chunk, drop_manifest, initial_state,
                                       make_dangling_tmp, truncate_chunk)
from repro_torch.stencil import (CheckpointedRun, ResidentPipeline,
                                 checkpoint_bytes_per_interval,
                                 checkpoint_traffic_fraction)


@pytest.fixture()
def tmp_ckpt(tmp_path):
    return str(tmp_path / "ckpt")


def _save_steps(d, steps):
    for s in steps:
        ckpt.save(d, s, {"state": np.full(8, float(s), np.float32)},
                  meta={"step": s})


# ------------------------------------------------- hardened checkpoint layer
def test_valid_steps_skips_tmp_and_manifestless(tmp_ckpt):
    _save_steps(tmp_ckpt, [2, 4])
    make_dangling_tmp(tmp_ckpt, 6)            # writer died pre-rename
    drop_manifest(tmp_ckpt, 4)                # torn checkpoint
    os.makedirs(os.path.join(tmp_ckpt, "step_bogus"))  # junk name
    assert ckpt.valid_steps(tmp_ckpt) == [2]
    assert ckpt.latest_step(tmp_ckpt) == 2
    _, meta = ckpt.restore(tmp_ckpt)
    assert meta["step"] == 2


def test_latest_step_empty_and_missing(tmp_ckpt):
    assert ckpt.latest_step(tmp_ckpt) is None
    os.makedirs(tmp_ckpt)
    make_dangling_tmp(tmp_ckpt, 1)
    assert ckpt.latest_step(tmp_ckpt) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_ckpt)


@pytest.mark.parametrize("corrupt", [truncate_chunk, bitflip_chunk],
                         ids=["truncate", "bitflip"])
def test_corrupt_chunk_falls_back_and_quarantines(tmp_ckpt, corrupt):
    """crc32/readability failures on the newest checkpoint fall back to
    the previous valid step and quarantine the corrupt dir."""
    _save_steps(tmp_ckpt, [3, 6])
    corrupt(tmp_ckpt, 6)
    got, meta = ckpt.restore(tmp_ckpt)
    assert meta["step"] == 3
    np.testing.assert_array_equal(got["state"], np.full(8, 3.0, np.float32))
    assert os.path.isdir(os.path.join(tmp_ckpt, ".corrupt_step_00000006"))
    assert ckpt.valid_steps(tmp_ckpt) == [3]  # quarantined dir is skipped


def test_corrupt_explicit_step_raises(tmp_ckpt):
    _save_steps(tmp_ckpt, [5])
    bitflip_chunk(tmp_ckpt, 5)
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(tmp_ckpt, 5)
    # no fallback target left -> FileNotFoundError carrying the cause
    with pytest.raises(FileNotFoundError, match="crc|chunk"):
        ckpt.restore(tmp_ckpt)


def test_restore_without_verify_skips_crc(tmp_ckpt):
    _save_steps(tmp_ckpt, [1])
    bitflip_chunk(tmp_ckpt, 1)
    try:  # bitflip may hit zip structure (unreadable either way) or payload
        got, meta = ckpt.restore(tmp_ckpt, 1, verify=False)
        assert meta["step"] == 1
    except CheckpointCorruptError as e:
        assert "unreadable" in str(e)
    with pytest.raises(CheckpointCorruptError):
        ckpt.restore(tmp_ckpt, 1)  # verify=True refuses the same dir


def test_save_retries_transient_io_error(tmp_ckpt, monkeypatch):
    """One transient OSError during the write is absorbed by the retry;
    the checkpoint lands intact. A budget of failures re-raises."""
    real_rename = os.rename
    fails = {"n": 1}

    def flaky_rename(src, dst):
        if fails["n"] and ".tmp_step_" in str(src):
            fails["n"] -= 1
            raise OSError("transient")
        return real_rename(src, dst)

    monkeypatch.setattr(os, "rename", flaky_rename)
    ckpt.save(tmp_ckpt, 9, {"x": np.arange(4)}, meta={"step": 9},
              retries=2, backoff=0.0)
    assert ckpt.latest_step(tmp_ckpt) == 9
    with pytest.raises(OSError):
        fails["n"] = 10  # fails every attempt -> exhausts the budget
        ckpt.save(tmp_ckpt, 10, {"x": np.arange(4)}, retries=1, backoff=0.0)
    assert not os.path.exists(os.path.join(tmp_ckpt, ".tmp_step_00000010"))


def test_keep_prunes_old_checkpoints(tmp_ckpt):
    state0 = initial_state("gol", 8, seed=8)
    pipe = ResidentPipeline(M=8, T=4, rule="gol", kind="morton", device="cpu")
    CheckpointedRun(pipe, tmp_ckpt, interval=2, keep=2).run(state0, 8)
    assert ckpt.valid_steps(tmp_ckpt) == [6, 8]


# ----------------------------------------------------------- leaf dtypes
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.int32,
                                   torch.bfloat16, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_tensor_leaves_roundtrip_bit_exact(tmp_ckpt, dtype):
    """A tensor leaf comes back bit-equal: numpy for the dtypes numpy has,
    a CPU tensor viewed from its bits for bf16 and fp8 (written as
    uint16/uint8 under the logical name, as the JAX package writes
    them); ``device=`` puts every leaf on that device as a tensor."""
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 5))
                         .astype(np.float32) * 8).to(dtype)
    ckpt.save(tmp_ckpt, 1, {"a": {"b": x}, "n": np.arange(3)})
    with open(os.path.join(tmp_ckpt, "step_00000001", "manifest.json")) as f:
        index = json.load(f)["index"]
    assert index["a/b"]["dtype"] == str(dtype).split(".")[1]
    tree, _ = ckpt.restore(tmp_ckpt)
    got = tree["a"]["b"]
    if dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        assert isinstance(got, torch.Tensor) and got.dtype == dtype
    else:
        assert isinstance(got, np.ndarray)
        got = torch.from_numpy(got)
    assert (bits(got) == bits(x)).all()
    np.testing.assert_array_equal(tree["n"], np.arange(3))
    placed, _ = ckpt.restore(tmp_ckpt, 1, device="cpu")
    assert isinstance(placed["n"], torch.Tensor) and placed["a"]["b"].dtype == dtype


def test_save_async_then_wait(tmp_ckpt):
    x = torch.arange(10, dtype=torch.float32)
    ckpt.save_async(tmp_ckpt, 2, {"x": x}, meta={"step": 2})
    x.add_(100)  # the snapshot was taken at the call
    ckpt.wait()
    tree, meta = ckpt.restore(tmp_ckpt)
    assert meta == {"step": 2}
    np.testing.assert_array_equal(tree["x"], np.arange(10, dtype=np.float32))


# ------------------------------------------------- checkpoint-overhead model
def test_checkpoint_model():
    assert checkpoint_bytes_per_interval(32) == 32 ** 3 * 4
    assert checkpoint_bytes_per_interval((16, 8, 4), fields=2) == \
        2 * 16 * 8 * 4 * 4
    f16 = checkpoint_traffic_fraction(32, 8, 1, 16, S=4)
    f64 = checkpoint_traffic_fraction(32, 8, 1, 64, S=4)
    assert 0.0 < f64 < f16 < 1.0  # longer intervals amortise the snapshot


@pytest.mark.parametrize("M,T,g,S", [(256, 8, 1, 4), (64, 8, 1, 1),
                                     (128, 16, 2, 2), (32, 8, 1, 8)])
def test_checkpoint_models_equal_jax(M, T, g, S):
    """Integers and floats equal to the JAX package's, and the chip's main
    shape gives 18.18% of an interval's bytes at interval 4."""
    for fields in (1, 2):
        assert checkpoint_bytes_per_interval(M, fields=fields) == \
            jpipe.checkpoint_bytes_per_interval(M, fields=fields)
        for interval in (1, 4, 16):
            assert checkpoint_traffic_fraction(M, T, g, interval, S=S,
                                               fields=fields) == \
                jpipe.checkpoint_traffic_fraction(M, T, g, interval, S=S,
                                                  fields=fields)
    assert round(checkpoint_traffic_fraction(256, 8, 1, 4, S=4), 4) == 0.1818


# ---------------------------------------------- checkpoints across packages
@pytest.fixture(scope="module")
def crossed(tmp_path_factory):
    """This package writes ``port_ckpt``; the reference child then writes
    ``jax_ckpt`` and restores ``port_ckpt``."""
    work = tmp_path_factory.mktemp("ckpt_cross")
    tree = {"params": {}}
    for key, v in ckpt_tree().items():
        t = torch.from_numpy(v)
        if key in CKPT_DTYPES:
            t = t.to(getattr(torch, CKPT_DTYPES[key]))
        node = tree["params"] if key.startswith("params/") else tree
        node[key.split("/")[-1]] = t
    ckpt.save(str(work / "port_ckpt"), CKPT_STEP, tree, meta=CKPT_META)
    return work, recipe_arrays(work, "ckpt")


def _leaf(tree, key):
    node = tree["params"] if key.startswith("params/") else tree
    return node[key.split("/")[-1]]


def test_jax_checkpoint_restores_in_port(crossed):
    work, _ = crossed
    tree, meta = ckpt.restore(str(work / "jax_ckpt"))
    assert meta == CKPT_META
    for key, want in ckpt_tree().items():
        got = _leaf(tree, key)
        if key in CKPT_DTYPES:
            assert isinstance(got, torch.Tensor) and \
                got.dtype == getattr(torch, CKPT_DTYPES[key])
            got = got.float().numpy()
        assert got.dtype == want.dtype or key in CKPT_DTYPES
        assert (bits(np.asarray(got, dtype=want.dtype)) == bits(want)).all(), key


def test_port_checkpoint_restores_in_jax(crossed):
    _, ref = crossed
    assert json.loads(str(ref["port_meta"])) == CKPT_META
    for key, want in ckpt_tree().items():
        assert str(ref[f"port/{key}/dtype"]) == CKPT_DTYPES.get(key, str(want.dtype))
        assert (bits(ref[f"port/{key}"].astype(want.dtype)) == bits(want)).all(), key


def test_manifests_and_chunks_agree_across_packages(crossed):
    """The two packages' checkpoints of the same tree: the same manifest
    keys, index entries (file, shape, dtype, crc32) and npz keys."""
    work, _ = crossed
    found = {}
    for name in ("jax_ckpt", "port_ckpt"):
        d = work / name / f"step_{CKPT_STEP:08d}"
        with open(d / "manifest.json") as f:
            found[name] = json.load(f)
        with np.load(d / "arrays_00.npz") as z:
            found[name]["npz"] = sorted(z.files)
    j, p = found["jax_ckpt"], found["port_ckpt"]
    assert set(j) == set(p) and j["index"] == p["index"]
    assert j["npz"] == p["npz"] == ["cursor", "params::e4", "params::w", "state"]
    assert j["n_chunks"] == p["n_chunks"] == 1 and j["meta"] == p["meta"]
