"""The language model over a torch device mesh: partition specs, the
sanitised specs, the Hilbert device order, the production meshes, the
sharded train step and the sharding hints, against the JAX package.

The JAX side runs in the reference subprocess (tests/_torch_oracle.py,
recipe ``sharding``, on 512 host devices): every arch's specs and decode
cache specs, ``sanitize_specs`` over four meshes, the Hilbert order, the
production meshes, and three single-device train steps of the elastic
run's reduced smollm-360m. The port's mesh runs on four gloo ranks of a
(2, 2) ("data", "model") mesh (``shard_arrays``, the cases in
tests/_torch_shard_cases.py); the production meshes under the fake
process group of 256 and 512 ranks. Specs are compared as tuples (JSON).
"""

import json
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_oracle import (DECODE_RULES, HILBERT_NS, SHARD_MESHES,
                           reference_arrays, shard_arrays, spec_code,
                           torus_devices)
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.dryrun import _axis_size, _batch_specs, sanitize_specs
from repro_torch.models import Model
from repro_torch.models import transformer as tfm
from repro_torch.models.params import (LOGICAL_RULES, ParamDef, Spec,
                                       constrain, gathered, leaf_paths,
                                       partition_specs, placements)
from repro_torch.configs import smollm_360m

# f32 on both sides, summed in other orders (and over the mesh's partial
# sums): losses and grad norms agree to 1e-5 relative; parameters after a
# step to the tolerance of test_torch_train's three steps (AdamW's first
# steps divide by |g| + 1e-8, so gradients near zero turn rounding into
# differences of a few parts in 1e5 of a step)
F32_TOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return reference_arrays(tmp_path_factory, "sharding")


@pytest.fixture(scope="module")
def steps(ref, tmp_path_factory):
    init = {k: v for k, v in ref.items() if k.startswith("init/")}
    return shard_arrays(tmp_path_factory.mktemp("step"), "step", 4, init)


@pytest.fixture(scope="module")
def hints(tmp_path_factory):
    return shard_arrays(tmp_path_factory.mktemp("hints"), "hints", 4)


def _mesh(sizes: dict):
    """An object read as a mesh of these axis sizes (``sanitize_specs``
    reads its dim names and shape only)."""
    return types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))


def _codes(tree) -> dict:
    return {"/".join(path): spec_code(s) for path, s in leaf_paths(tree)}


def _ref_codes(ref, prefix) -> dict:
    pre = prefix + "/"
    return {k[len(pre):]: str(v) for k, v in ref.items() if k.startswith(pre)}


# ------------------------------------------------------------------ specs
@pytest.mark.parametrize("arch", ARCHS)
def test_partition_specs_equal_jax(ref, arch):
    got = partition_specs(tfm.model_defs(get_config(arch)))
    assert _codes(got) == _ref_codes(ref, f"specs/{arch}")
    assert all(isinstance(s, Spec) for _, s in leaf_paths(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(ref, arch):
    cfg = get_config(arch)
    for case, (B, S, rules) in DECODE_RULES.items():
        got = partition_specs(tfm.cache_defs(cfg, B, S), extra_rules=rules)
        assert _codes(got) == _ref_codes(ref, f"cache/{arch}/{case}"), case
        fixed = sanitize_specs(_mesh(SHARD_MESHES["16x16"]), got,
                               tfm.cache_defs(cfg, B, S))
        assert _codes(fixed) == _ref_codes(ref, f"cache_sanitized/{arch}/{case}"), case


@pytest.mark.parametrize("mesh", sorted(SHARD_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_specs_equal_jax(ref, arch, mesh):
    defs = tfm.model_defs(get_config(arch))
    got = sanitize_specs(_mesh(SHARD_MESHES[mesh]), partition_specs(defs), defs)
    assert _codes(got) == _ref_codes(ref, f"sanitized/{arch}/{mesh}")


def test_model_specs_are_the_defs_specs():
    cfg = smollm_360m.SMOKE
    model = Model(cfg, device="cpu")
    assert model.specs() == partition_specs(tfm.model_defs(cfg))
    rules = DECODE_RULES["b8"][2]
    assert model.cache_specs(8, 16, extra_rules=rules) == partition_specs(
        tfm.cache_defs(cfg, 8, 16), extra_rules=rules)
    assert LOGICAL_RULES["embed"] == "data" and LOGICAL_RULES["layers"] is None


def test_spec_reads_as_jax_reads_it():
    assert Spec(("data",), "model", None) == ("data", "model", None)
    assert Spec((), ("pod", "data")) == (None, ("pod", "data"))
    mesh = _mesh(SHARD_MESHES["2x16x16"])
    assert _axis_size(mesh, None) == 1 and _axis_size(mesh, ("pod", "data")) == 32
    batch = {"tokens": torch.zeros(8, 4), "cur": torch.zeros(())}
    assert _batch_specs(batch, ("data",)) == {"tokens": ("data", None), "cur": ()}
    # a dim no axis divides is replicated
    defs = {"w": ParamDef((5, 32), ("kv_heads", "embed"))}
    got = sanitize_specs(_mesh(SHARD_MESHES["16x16"]), partition_specs(defs), defs)
    assert got == {"w": (None, "data")}


def test_placements_name_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _mesh(SHARD_MESHES["2x16x16"])
    assert placements(Spec(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert placements(Spec(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert placements(Spec(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        placements(Spec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(Spec("model", "model"), mesh)


def test_constrain_and_gathered_pass_plain_tensors():
    x = torch.ones(2, 3, 4)
    assert constrain(x, ("data", "model", None)) is x and gathered(x, 1) is x


# ----------------------------------------------------------- device order
@pytest.mark.parametrize("n", HILBERT_NS)
def test_hilbert_permutation_equals_jax(ref, n):
    got = tmesh.hilbert_device_permutation(list(range(n)))
    np.testing.assert_array_equal(got, ref[f"hilbert/{n}"])
    assert sorted(got) == list(range(n))


def test_hilbert_permutation_reads_coords(ref):
    got = [d.id for d in tmesh.hilbert_device_permutation(torus_devices())]
    np.testing.assert_array_equal(got, ref["hilbert/torus"])
    # consecutive devices are torus neighbours
    by_id = {d.id: d.coords for d in torus_devices()}
    steps_ = [sum(abs(a - b) for a, b in zip(by_id[x], by_id[y]))
              for x, y in zip(got, got[1:])]
    assert max(steps_) == 1


@pytest.mark.parametrize("name,multi", [("single", False), ("multi", True)])
def test_production_mesh_equals_jax(ref, name, multi):
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = 512 if multi else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        mesh = tmesh.make_production_mesh(multi_pod=multi, device_type="cpu")
        np.testing.assert_array_equal(mesh.mesh.numpy(), ref[f"mesh/{name}/ids"])
        assert list(mesh.mesh_dim_names) == json.loads(str(ref[f"mesh/{name}/names"]))
        assert list(tmesh.batch_axes(mesh)) == json.loads(
            str(ref[f"mesh/{name}/batch_axes"]))
        assert mesh.mesh_dim_names == (tmesh.MESH_AXES_MULTI if multi
                                       else tmesh.MESH_AXES_SINGLE)
        if not multi:
            with pytest.raises(RuntimeError, match="512 ranks"):
                tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_production_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="256 ranks, have 0"):
        tmesh.make_production_mesh(device_type="cpu")


# ------------------------------------------------------------ the step
def _rank0(res, key):
    return res[f"{key}/rank0"]


def test_sharded_step_matches_jax(ref, steps):
    got = _rank0(steps, "mesh/metrics")
    for i, (loss, gn) in enumerate(got):
        np.testing.assert_allclose(loss, ref[f"steps/{i}/loss"], rtol=F32_TOL,
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(gn, ref[f"steps/{i}/grad_norm"], rtol=F32_TOL,
                                   err_msg=f"grad norm, step {i}")
    for r in range(4):  # every rank reports the same metrics
        np.testing.assert_array_equal(steps[f"mesh/metrics/rank{r}"], got)


def test_sharded_params_match_jax(ref, steps):
    finals = {k[len("final/"):]: v for k, v in ref.items() if k.startswith("final/")}
    assert finals
    for k, want in finals.items():
        np.testing.assert_allclose(_rank0(steps, f"mesh/final/{k}"), want,
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)


def test_sharded_step_matches_the_unsharded_port(steps):
    np.testing.assert_allclose(_rank0(steps, "mesh/metrics"),
                               _rank0(steps, "plain/metrics"), rtol=F32_TOL)
    keys = [k for k in steps if k.startswith("plain/final/") and k.endswith("rank0")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(steps[k.replace("plain/", "mesh/")], steps[k],
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=k)


def test_optimizer_state_lives_with_the_parameters(steps):
    for r in range(4):
        assert steps[f"mesh/m_is_dtensor/rank{r}"]
        assert steps[f"mesh/m_placements_match/rank{r}"]


def test_sharded_checkpoint_restores_onto_the_mesh(steps):
    """``save_async`` of the sharded parameters (gathered, written by the
    mesh's first rank, every rank waiting in ``wait``), restored by a
    callable ``shardings``: every shard bit-equal, placements kept."""
    assert all(steps[f"mesh/restored_bit_equal/rank{r}"] for r in range(4))


def test_microbatches_split_each_ranks_rows(steps):
    """Two microbatches of each rank's own rows: the same mean loss and
    gradient as the whole batch."""
    np.testing.assert_allclose(_rank0(steps, "micro/metrics"),
                               _rank0(steps, "mesh/metrics")[:1], rtol=F32_TOL)


# ------------------------------------------------------------- the hints
def test_moe_hints_keep_logits_and_drops(hints):
    for r in range(4):
        np.testing.assert_allclose(hints[f"moe/mesh/logits/rank{r}"],
                                   hints["moe/plain/logits/rank0"],
                                   rtol=F32_TOL, atol=F32_TOL)
    # each (data) shard of rows counts its own drops, once per model rank
    mesh_drops = sum(hints[f"moe/mesh/drops/rank{r}"] for r in range(4)
                     if hints[f"model_coord/rank{r}"] == 0)
    plain = hints["moe/plain/drops/rank0"]
    np.testing.assert_array_equal(mesh_drops, plain)
    assert plain.sum() > 0


def test_decode_with_score_spec_matches_unsharded(hints):
    assert all(hints[f"decode/cache_seq_split/rank{r}"] for r in range(4))
    for r in range(4):
        np.testing.assert_allclose(hints[f"decode/mesh/logits/rank{r}"],
                                   hints["decode/plain/logits/rank0"],
                                   rtol=F32_TOL, atol=F32_TOL)


def test_flash_with_q_heads_split_and_kv_whole(hints):
    """Trouble (a) of the mesh's flash path: 4 q heads split over "model",
    the one kv head replicated; each rank reads the kv head of its own
    global q heads, and the kv gradients are summed over "model"."""
    assert hints["gqa/flash_on_mesh_calls/rank0"] > 0
    assert all(hints[f"gqa/q_heads_split_kv_whole/rank{r}"] for r in range(4))
    np.testing.assert_allclose(hints["gqa/mesh/loss/rank0"],
                               hints["gqa/plain/loss/rank0"], rtol=F32_TOL)
    keys = [k for k in hints if k.startswith("gqa/plain/grads/") and k.endswith("rank0")]
    assert keys
    for k in keys:
        want = hints[k]
        got = hints[k.replace("plain", "mesh")]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=F32_TOL * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("case", ["kv2", "kv1", "mla"])
def test_attention_keeps_heads_split_on_the_mesh(hints, case):
    """Attention without the flash kernel on (2, 2): each rank attends its
    own batch rows and its own 2 of the 4 heads (the output split over
    "data" and, along its heads, over "model"), where the kv heads split
    with them, where the one kv head is taken whole, and in MLA; loss and
    gradients those of the unsharded model."""
    assert hints[f"heads/{case}/calls/rank0"] > 0
    assert all(hints[f"heads/{case}/heads_split/rank{r}"] for r in range(4))
    np.testing.assert_allclose(hints[f"heads/{case}/mesh/loss/rank0"],
                               hints[f"heads/{case}/plain/loss/rank0"],
                               rtol=F32_TOL)
    pre = f"heads/{case}/plain/grads/"
    keys = [k for k in hints if k.startswith(pre) and k.endswith("rank0")]
    assert keys
    for k in keys:
        want = hints[k]
        got = hints[k.replace("/plain/", "/mesh/")]
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=F32_TOL * np.abs(want).max(), err_msg=k)


def test_tuple_axis_splits_pod_major(hints):
    """Spec(("pod", "data")) over a (2, 2) ("pod", "data") mesh: rank (p, d)
    holds row block 2p + d, JAX's order."""
    for r in range(4):
        p, d = hints[f"pod_major/coord/rank{r}"]
        blk = 2 * p + d
        np.testing.assert_array_equal(hints[f"pod_major/rows/rank{r}"],
                                      [2.0 * blk, 2.0 * blk + 1])
