"""The elastic training mode: a reduced smollm-360m trained on a (4, 2)
mesh of 8 gloo ranks, checkpointed sharded, restored onto (2, 2) and
trained on (``launch.elastic.reshard_run``, the ``elastic`` case of
tests/_torch_shard_cases.py), against the JAX package's elastic run on 8
host devices (tests/_torch_oracle.py, recipe ``elastic``) from the same
initial weights. The CLI itself runs to ``[elastic] OK`` in
``tests/test_torch_resilience.py::test_elastic_cli_on_the_cpu``."""

import numpy as np
import pytest

from _torch_oracle import reference_arrays, shard_arrays
from repro_torch.launch import elastic

# f32 on both sides; the six losses sum in other orders over other meshes
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "elastic")


@pytest.fixture(scope="module")
def run(ref, tmp_path_factory):
    init = {k: v for k, v in ref.items() if k.startswith("init/")}
    return shard_arrays(tmp_path_factory.mktemp("elastic"), "elastic", 8, init)


def test_reshard_losses_match_jax(ref, run):
    got = run["losses/rank0"]
    assert got.shape == (6,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)
    for r in range(4):  # the ranks of mesh B report the same six losses
        np.testing.assert_array_equal(run[f"losses/rank{r}"], got)
    for r in range(4, 8):  # the others train on mesh A only
        np.testing.assert_array_equal(run[f"losses/rank{r}"], got[:3])


def test_reshard_keeps_params_bit_exact(ref, run):
    assert bool(ref["bit_exact"])
    assert all(bool(run[f"bit_exact/rank{r}"]) for r in range(4))
    assert not any(f"bit_exact/rank{r}" in run for r in range(4, 8))


def test_cli_defaults_and_shape_checks():
    a = elastic.build_parser().parse_args([])
    assert (a.device, a.devices, a.from_shape, a.to_shape) == ("cuda", 8, "4,2", "2,2")
    assert not a.stencil and a.rank is None
    for argv in (["--devices", "4"], ["--to-shape", "4,4"]):
        with pytest.raises(SystemExit, match="must cover"):
            elastic.main(elastic.build_parser().parse_args(argv))


def test_a_rank_targets_the_card_unless_asked(monkeypatch):
    """Without --device the CLI asks for CUDA and raises here, before it
    starts a rank; it never falls back to the CPU. On the card it needs a
    card a rank."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    a = elastic.build_parser().parse_args([])
    with pytest.raises(RuntimeError, match="cuda"):
        elastic.main(a)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 8 cards, 1 found"):
        elastic.main(a)
    cpu = elastic.build_parser().parse_args(["--device", "cpu"])
    assert str(elastic._rank_device(cpu, 3)[0]) == "cpu"
    assert elastic._rank_device(cpu, 3)[1] == "gloo"


def test_elastic_config_is_the_references():
    cfg = elastic.elastic_config()
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
            cfg.d_ff, cfg.vocab, cfg.activation_dtype) == (
        2, 128, 4, 2, 32, 256, 512, "float32")
