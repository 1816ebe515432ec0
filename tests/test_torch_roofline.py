"""The port's roofline machinery (``repro_torch.roofline``): the op-by-op
count on known graphs, held to exact numbers, and the H100 roofline terms.
The counterparts of tests/test_roofline.py's checks of the JAX package's
loop-aware HLO cost model; in eager PyTorch a loop runs unrolled, so the
counts are exact where the JAX ones are within a tolerance."""

import pytest
import torch
import torch.distributed as dist

from repro_torch.roofline import HW, RooflineCell, analyze, charge_kernel, count
from repro_torch.roofline.op_cost import tree_bytes


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_flops_exact():
    a, b = _meta(256, 512), _meta(512, 1024)
    with count() as c:
        (a @ b).sum()
    assert c.flops_by_kind["matmul"] == 2 * 256 * 512 * 1024
    assert c.flops_by_kind["reduction"] == 256 * 1024
    assert c.matmul_flops_by_dtype == {"float32": 2 * 256 * 512 * 1024}
    # mm reads both operands and writes its result; sum reads it again
    assert c.bytes == 4 * (256 * 512 + 512 * 1024 + 2 * 256 * 1024) + 4
    assert c.torch_raw == {"flops": 2 * 256 * 512 * 1024}


def _layers(L, D=64, rows=4):
    w, x = _meta(L, D, D), _meta(rows, D)
    with count() as c:
        for i in range(L):
            x = x @ w[i]
        x.sum()
    return c


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_layer_loop_flops_scale_with_length(device):
    """A Python loop over a stacked (L, D, D) weight: L times one layer's
    flops and bytes (the sum's cost is L-free)."""
    def run(L):
        w = torch.zeros((L, 64, 64), device=device)
        x = torch.zeros((4, 64), device=device)
        with count() as c:
            for i in range(L):
                x = x @ w[i]
        return c

    f4, f16 = run(4), run(16)
    assert f4.flops == 4 * 2 * 4 * 64 * 64
    assert f16.flops == 4 * f4.flops
    assert f16.bytes == 4 * f4.bytes


def test_nested_loop_exact():
    w, x = _meta(5, 32, 32), _meta(2, 32)
    with count() as c:
        for i in range(5):
            for _ in range(3):
                x = x @ w[i]
    assert c.flops == 5 * 3 * 2 * 2 * 32 * 32


def test_stacked_weight_slice_not_overcounted():
    """A layer's slice of a stacked weight is charged where the product
    reads it: each layer's (D, D) slice once, never the (L, D, D) buffer."""
    L, D, rows = 64, 128, 4
    w, x = _meta(L, D, D), _meta(rows, D)
    with count() as c:
        for i in range(L):
            x = torch.tanh(x @ w[i])
    act = rows * D * 4
    per_layer = (act + D * D * 4 + act) + (act + act)  # mm, then tanh
    assert c.bytes == L * per_layer
    assert c.bytes < L * (L * D * D * 4) / 4
    assert c.flops == L * (2 * rows * D * D + rows * D)


def test_views_cost_nothing_gathers_and_scatters_their_rows():
    x = _meta(64, 32)
    idx = torch.zeros(8, dtype=torch.int64, device="meta")
    upd = _meta(8, 32)
    with count() as c:
        x.view(32, 64).t()[1:3]
        x.unsqueeze(0).expand(4, 64, 32).permute(2, 0, 1)
    assert (c.flops, c.bytes) == (0, 0)
    with count() as c:
        x.index_select(0, idx)
    assert c.bytes == 2 * 8 * 32 * 4 and c.flops == 0
    with count() as c:
        x.index_put_((idx,), upd)
    assert c.bytes == 2 * 8 * 32 * 4
    with count() as c:
        x.copy_(_meta(64, 32, dtype=torch.bfloat16))
    assert c.bytes == 64 * 32 * (4 + 2) and c.flops == 0


def test_charged_kernel_is_listed_and_counts_bytes():
    q = torch.zeros(2, 16, 8)
    out = torch.zeros(2, 16, 8)
    charge_kernel("k", (q, q, q), out)  # no count open: nothing happens
    with count() as c:
        charge_kernel("k", (q, q, q), out)
        charge_kernel("k", (q, q, q), out)
    assert c.kernels == {"k": {"launches": 2, "bytes": 2 * 4 * q.numel() * 4}}
    assert c.bytes == 2 * 4 * q.numel() * 4 and c.flops == 0


def test_peak_memory_follows_live_storages():
    """a, then b, a freed, then c: the peak is b + c; views and in-place
    ops allocate nothing."""
    with count() as c:
        a = torch.empty(1000, device="meta")
        b = torch.empty(2000, device="meta")
        b.view(2, 1000).add_(1.0)
        del a
        c_ = torch.empty(3000, device="meta")
        del b, c_
    assert c.memory["peak_bytes"] == 4 * (2000 + 3000)
    assert c.memory["live_at_end_bytes"] == 0
    assert c.memory["temp_bytes"] == c.memory["peak_bytes"]
    x = torch.zeros(10)
    with count(args={"x": x, "again": x}) as c:
        y = x * 2
    assert c.memory["argument_bytes"] == 40
    assert c.memory["live_at_end_bytes"] == 40 and c.memory["temp_bytes"] == 0
    assert tree_bytes({"y": y, "z": [y]}) == 40


@pytest.fixture
def group8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        yield DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                         mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_dtensor_counts_one_device(group8):
    """(16, 256) @ (256, 1024) split (2, 4) ways: this device's product on
    its shards, FlopCounterMode's count the global product."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    a = distribute_tensor(_meta(16, 256), group8, [Shard(0), Replicate()])
    b = distribute_tensor(_meta(256, 1024), group8, [Shard(0), Shard(1)])
    a @ b  # DTensor's first-time sharding propagation: the count's warm-up
    with count() as c:
        a @ b
    assert c.flops_by_kind["matmul"] == 2 * 8 * 256 * 256
    assert c.torch_raw["flops"] == 2 * 16 * 256 * 1024


def test_redistribute_charges_all_gather_result_bytes(group8):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    x = distribute_tensor(_meta(16, 256), group8, [Shard(0), Replicate()])
    x.redistribute(placements=[Replicate(), Replicate()])  # its planning, once
    with count() as c:
        y = x.redistribute(placements=[Replicate(), Replicate()])
    assert c.coll_bytes == {"all-gather": 16 * 256 * 4, "all-reduce": 0,
                            "reduce-scatter": 0, "all-to-all": 0,
                            "collective-permute": 0}
    assert c.flops == 0
    assert tree_bytes(y) == 16 * 256 * 4 and tree_bytes(x) == 8 * 256 * 4


def test_roofline_cell_terms():
    cell = RooflineCell(arch="a", shape="s", mesh="m", n_devices=8,
                        flops=989e12 * 0.010 + 67e12 * 0.003,   # 13 ms compute
                        bytes_accessed=3.35e12 * 0.002,          # 2 ms memory
                        coll_bytes={"all-reduce": 450e9 * 0.004},  # 4 ms
                        model_flops_global=989e12 * 8 * 0.0065,
                        matmul_flops_by_dtype={"bfloat16": 989e12 * 0.010,
                                               "float32": 67e12 * 0.001})
    assert cell.t_compute == pytest.approx(0.013, rel=1e-12)
    assert cell.t_memory == pytest.approx(0.002, rel=1e-12)
    assert cell.collective_link == "nvlink"
    assert cell.t_collective == pytest.approx(0.004, rel=1e-12)
    assert cell.bottleneck == "compute"
    assert cell.t_bound == pytest.approx(0.013, rel=1e-12)
    assert cell.mfu_bound == pytest.approx(0.5, rel=1e-12)
    # a mesh past one node of 8 takes the between-nodes rate
    wide = RooflineCell(arch="a", shape="s", mesh="m", n_devices=256, flops=0,
                        bytes_accessed=0, coll_bytes={"all-gather": 50e9 * 0.004})
    assert wide.collective_link == "internode"
    assert wide.t_collective == pytest.approx(0.004, rel=1e-12)
    assert wide.bottleneck == "collective"
    rec = wide.to_dict()
    assert rec["collective_link"] == "internode" and rec["hw"] == HW


def test_analyze_reads_the_count():
    a, b = _meta(128, 64, dtype=torch.bfloat16), _meta(64, 32, dtype=torch.bfloat16)
    with count() as c:
        a @ b
    cell = analyze("a", "s", "m", 1, c, 2 * 128 * 64 * 32)
    assert cell.flops == cell.flops_tensor_core == 2 * 128 * 64 * 32
    assert cell.t_compute == cell.flops / 989e12
    assert cell.useful_flops_frac == 1.0
    assert cell.coll_bytes == {}
    assert cell.to_dict()["torch_raw"] == {"flops": 2 * 128 * 64 * 32}


def test_hw_constants_are_the_h100s():
    assert HW["flops_bf16"] == 989e12
    assert HW["flops_f32"] == 67e12
    assert HW["hbm_bw"] == 3.35e12
    assert HW["nvlink_bw"] == 450e9
    assert HW["internode_bw"] == 50e9
    assert HW["gpus_per_node"] == 8
