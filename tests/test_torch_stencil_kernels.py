"""The stencil kernels' wrappers on CPU tensors (their plain versions)
against the JAX package's oracle, on the same numpy inputs.

gol and wave are exact in f32 by construction (DESIGN.md §4, §9), so they
must be bit-equal. jacobi is compared at rtol=atol=1e-6: XLA may contract
or rewrite the JAX side's arithmetic (FMA contraction, division by a
constant), which moves the last ulp. The CUDA kernels are held against the
same plain versions on the card by chip_smoke.py; the Pallas kernels
themselves are in tests/test_torch_stencil_pallas.py.
"""

import numpy as np
import pytest
import torch

from _torch_oracle import (BCS, KINDS, RULES, assert_matches, boundary,
                           jax_fused, port_fused, random_store, tables, to_torch)
from repro_torch.core import boundary as tbnd
from repro_torch.core import neighbors as tnbr
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil3d as tk
from repro_torch.kernels.ops import uniform_weights
from repro_torch.kernels.rules import apply_window_bc, get_rule

M, T = 16, 4


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_matches_jax_oracle(kind, bc):
    """4 orderings × 4 boundaries here, × S ∈ {1, 2, 4} × {gol, jacobi,
    wave} inside (S=4 needs T=4, g=1)."""
    nt = M // T
    for rule in RULES:
        seed = 100 * KINDS.index(kind) + 10 * BCS.index(bc) + RULES.index(rule)
        store = random_store(rule, nt ** 3, T, seed)
        for S in (1, 2, 4):
            got = port_fused(store, kind, nt, bc, S, rule)
            assert_matches(got, jax_fused(store, kind, nt, bc, S, rule),
                           rule, (kind, bc, rule, S))


def test_fused_writes_into_out():
    nt = M // T
    store = torch.from_numpy(random_store("gol", nt ** 3, T, seed=2))
    w = uniform_weights(1, "cpu")
    nbr = tnbr.neighbor_table_device("morton", nt, device="cpu")
    out = torch.full_like(store, -1.0)
    got = tk.stencil_step_fused(store, w, nbr, g=1, S=2, out=out)
    assert got is out
    assert torch.equal(out, tref.stencil_fused_ref(store, w, nbr, S=2))


def _refused_call(case):
    nt = M // T
    w = uniform_weights(1, "cpu")
    store = torch.from_numpy(random_store("gol", nt ** 3, T, seed=3))
    nbr = tnbr.neighbor_table_device("morton", nt, device="cpu")
    if case == "dtype":
        return lambda: tk.stencil_step_fused(store.double(), w, nbr, g=1)
    if case == "S*g":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, S=3)
    if case == "alias":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, out=store)
    if case == "smem":  # T=32, S=8: two (32+16)³ f32 windows > 227 KB
        big = torch.zeros((1, 32, 32, 32))
        one = tnbr.neighbor_table_device("morton", 1, device="cpu")
        return lambda: tk.stencil_step_fused(big, w, one, g=1, S=8)
    if case == "bnd":
        return lambda: tk.stencil_step_fused(store, w, nbr, g=1, bc="neumann0")
    if case == "blocks_dtype":  # f32, bf16 and f16 blocks are taken
        wide = torch.zeros((1, 6, 6, 6), dtype=torch.float64)
        return lambda: tk.stencil_sum_blocks(wide, w, g=1)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "S*g", "alias", "smem", "bnd",
                                  "blocks_dtype"])
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    with pytest.raises((ValueError, TypeError)):
        _refused_call(case)()


def test_smem_model_matches_the_kernel_layout():
    """Two C·(T+2Sg)³ f32 windows plus 33 int32 table entries."""
    assert tk.fused_smem_bytes(8, 1, 4) == 2 * 16 ** 3 * 4 + 132
    assert tk.fused_smem_bytes(16, 1, 4, fields=2) == 221_184 + 132
    assert tk.fused_smem_bytes(16, 1, 4, fields=2) <= tk.SMEM_LIMIT_BYTES
    assert tk.halo_smem_bytes(8, 1) == 10 ** 3 * 4


def test_sm90_smem_model_matches_the_kernel_layout():
    """Three C·(T+2Sg)³ f32 windows plus two rows of 33 int32 table
    entries (csrc/stencil3d_sm90.cu, fits())."""
    assert tk.sm90_smem_bytes(8, 1, 4) == 3 * 16 ** 3 * 4 + 264
    assert tk.sm90_smem_bytes(8, 1, 1) == 3 * 10 ** 3 * 4 + 264
    assert tk.sm90_smem_bytes(16, 1, 2, fields=2) == 192_264 <= tk.SMEM_LIMIT_BYTES
    assert tk.sm90_smem_bytes(16, 1, 4, fields=2) > tk.SMEM_LIMIT_BYTES
    assert tk.sm90_smem_bytes(8, 1, 8) == 165_888 + 264 <= tk.SMEM_LIMIT_BYTES
    # it needs a window more than the first design's
    for T, g, S, C in ((8, 1, 4, 1), (16, 2, 1, 2)):
        assert tk.sm90_smem_bytes(T, g, S, fields=C) > tk.fused_smem_bytes(T, g, S, fields=C)


def test_group_smem_model_matches_the_kernel_layout():
    """Two C·(2T+2Sg)³ f32 windows, or three where the next group's is
    prefetched, plus two group-table rows of 72 int32 entries
    (csrc/stencil3d_sm90.cu, group_bytes())."""
    assert tk.group_smem_bytes(8, 1, 4, fields=2) == 2 * 2 * 24 ** 3 * 4 + 576
    assert tk.group_smem_bytes(8, 1, 4, fields=2) == 221_760 <= tk.SMEM_LIMIT_BYTES
    assert tk.group_smem_bytes(8, 1, 4, fields=2, windows=3) > tk.SMEM_LIMIT_BYTES
    assert tk.group_smem_bytes(8, 1, 4, windows=3) == 165_888 + 576 <= tk.SMEM_LIMIT_BYTES
    assert tk.group_smem_bytes(8, 1, 2, fields=2, windows=3) == 192_576
    assert tk.group_smem_bytes(8, 2, 2) == tk.group_smem_bytes(8, 1, 4)  # H = 4
    assert tk.group_smem_bytes(8, 1, 8) > tk.SMEM_LIMIT_BYTES  # two 32³ windows
    assert tk.group_smem_bytes(8, 2, 4) > tk.SMEM_LIMIT_BYTES


# The shapes of the parametrised cases below whose group design has an
# instance: over a whole periodic cube they take it.
_GROUPED = {(8, 1, 4, 1), (8, 1, 2, 2), (8, 1, 4, 2), (8, 2, 1, 1), (8, 2, 2, 2),
            (8, 2, 1, 2)}


@pytest.mark.parametrize("T,g,S,C,want", [
    (8, 1, 4, 1, "sm90"),     # the resident and distributed main paths
    (8, 1, 1, 1, "sm90"),     # stencil_sum_resident's main shape
    (8, 1, 2, 2, "sm90"),     # the wave main paths
    (16, 1, 4, 1, "sm90"),    # what plan() picks at M=256
    (8, 1, 8, 1, "sm90"),
    (8, 2, 4, 1, "sm90"),
    (16, 2, 2, 1, "sm90"),
    (16, 2, 1, 2, "sm90"),
    (16, 1, 4, 2, "simple"),  # three (24³, 2 channels) windows do not fit
    (8, 1, 8, 2, "simple"),
    (16, 1, 8, 1, "simple"),
    (16, 2, 2, 2, "simple"),
    (4, 1, 1, 1, "simple"),   # T outside {8, 16}
    (32, 1, 1, 1, "simple"),
    (16, 4, 1, 1, "simple"),  # g outside {1, 2}
    (8, 1, 3, 1, "simple"),   # S·g does not divide T
    (8, 1, 2, 3, "simple"),   # three channels
    (8, 1, 4, 2, "sm90"),     # the wave cells' shape
    (8, 2, 1, 1, "sm90"),
    (8, 2, 2, 2, "sm90"),
    (8, 2, 1, 2, "sm90"),
])
def test_fused_design_is_a_function_of_the_shape(T, g, S, C, want):
    """The block designs for any store; over a whole periodic cube of an
    even edge the group design where it has an instance (T=8, S·g ≥ 2, two
    windows fit), else the same design."""
    assert tk.fused_design(T, g, S, C) == want
    grouped = "sm90_group" if (T, g, S, C) in _GROUPED else want
    assert tk.fused_design(T, g, S, C, cube=True) == grouped
    assert tk.fused_design(T, g, S, C, torch.bfloat16, cube=True) == "simple"


def test_fused_design_over_its_whole_domain():
    """sm90 exactly where the Hopper design has an instance: T ∈ {8, 16},
    g ∈ {1, 2}, S·g | T, C ∈ {1, 2} and three windows fit; 12 (T, g, S)
    for one channel (each built for gol, jacobi and identity) and 8 for
    two (wave): the 44 kernels of csrc/stencil3d_sm90.cu."""
    picked = {C: [] for C in (1, 2)}
    for T in range(1, 33):
        for g in range(1, 5):
            for S in range(1, 33):
                for C in (1, 2, 3):
                    design = tk.fused_design(T, g, S, C)
                    assert design in ("sm90", "simple")
                    fits = 12 * C * (T + 2 * S * g) ** 3 + 264 <= 232_448
                    want = (T in (8, 16) and g in (1, 2) and C < 3
                            and T % (S * g) == 0 and fits)
                    assert (design == "sm90") == want, (T, g, S, C)
                    if want:
                        picked[C].append((T, g, S))
    assert len(picked[1]) == 12 and len(picked[2]) == 8
    assert all(S in (1, 2, 4, 8, 16) for _, _, S in picked[1])


def test_group_design_over_its_whole_domain():
    """Over a whole periodic cube: sm90_group exactly where the group
    design has an instance (T=8, g ∈ {1, 2}, C ∈ {1, 2}, S·g | T, S·g ≥ 2,
    two windows fit), the block design's choice elsewhere; 4 (g, S) for
    each channel count: the 16 group kernels of csrc/stencil3d_sm90.cu
    (3 rules of one channel, wave of two)."""
    picked = {C: [] for C in (1, 2)}
    for T in range(1, 33):
        for g in range(1, 5):
            for S in range(1, 33):
                for C in (1, 2, 3):
                    design = tk.fused_design(T, g, S, C, cube=True)
                    fits = 8 * C * (2 * T + 2 * S * g) ** 3 + 576 <= 232_448
                    want = (T == 8 and g in (1, 2) and C < 3 and T % (S * g) == 0
                            and S * g >= 2 and fits)
                    if want:
                        assert design == "sm90_group", (T, g, S, C)
                        picked[C].append((g, S))
                    else:
                        assert design == tk.fused_design(T, g, S, C), (T, g, S, C)
    assert picked[1] == picked[2] == [(1, 2), (1, 4), (2, 1), (2, 2)]


def test_cpu_runs_count_no_design():
    nt = M // T
    store = torch.from_numpy(random_store("gol", nt ** 3, T, seed=5))
    nbr = tnbr.neighbor_table_device("hilbert", nt, device="cpu")
    before = dict(_build.STENCIL_DESIGN_LAUNCHES)
    tk.stencil_step_fused(store, uniform_weights(1, "cpu"), nbr, g=1, S=2)
    tk.stencil_sum_resident(store, uniform_weights(1, "cpu"), nbr, g=1)
    assert _build.STENCIL_DESIGN_LAUNCHES == before


def _jacobi_by_product(s: torch.Tensor, g: int) -> torch.Tensor:
    """The Hopper design's jacobi mean: the double product s·(1/n) rounded
    once to f32 (n = (2g+1)³, odd)."""
    return (s.double() * (1.0 / (2 * g + 1) ** 3)).float()


@pytest.mark.parametrize("g", [1, 2, 3])
def test_jacobi_product_is_the_ieee_quotient(g):
    """s·(1/n) in double, rounded to f32, equals s / n in f32 bit for bit
    over random bit patterns (normals, subnormals, zeros, infinities,
    NaNs) and around every power of two."""
    rng = np.random.default_rng(g)
    bits = rng.integers(0, 2 ** 32, size=400_000, dtype=np.uint64).astype(np.uint32)
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, 3e38, 27, 125],
                     dtype=np.float32)
    pow2 = np.float32(2.0) ** np.arange(-149, 128, dtype=np.float32)
    near = np.concatenate([np.nextafter(pow2, np.float32(0)), pow2,
                           np.nextafter(pow2, np.float32(np.inf))])
    s = torch.from_numpy(np.concatenate([bits.view(np.float32), edges, near, -near]))
    d = torch.full((), float((2 * g + 1) ** 3), dtype=torch.float32)
    got, want = _jacobi_by_product(s, g), s / d
    same = got.view(torch.int32) == want.view(torch.int32)
    assert bool((same | (got.isnan() & want.isnan())).all())


def _column_depth(g: int, O: int, nt: int = 128, nx: int = 2) -> int:
    """column_depth of csrc/stencil3d_sm90.cu: the depth nz ≤ 8 (g=1) or
    ≤ 2 (g=2) of the columns of a substep with O³ sites whose rounds of
    nt columns (128 in the block design, 512 in the group design) times
    the instructions of one column are fewest."""
    K = 2 * g + 1

    def cost(nz):
        return nz * (2 * nx * K ** 3 + 8) + (nz + 2 * g) * K * (nx + 2 * g) // 2 + 25

    def rounds(nz):
        return (-(-O // nz) * O * (O // nx) + nt - 1) // nt

    best = 1
    for nz in range(2, min(8 if g == 1 else 2, O) + 1):
        if rounds(nz) * cost(nz) <= rounds(best) * cost(best):
            best = nz
    return best


def test_column_depths_of_the_main_shapes():
    """The substeps of T=8, S=4, g=1 (O = 14, 12, 10, 8) and of S=1."""
    assert [_column_depth(1, O) for O in (14, 12, 10, 8)] == [3, 4, 2, 2]
    assert _column_depth(2, 8) == 2 and _column_depth(2, 12) == 1
    # the group design's 512 threads at S=4 (O = 22, 20, 18, 16) and g=2
    assert [_column_depth(1, O, 512) for O in (22, 20, 18, 16)] == [6, 4, 6, 4]
    assert _column_depth(2, 20, 512) == 2 and _column_depth(2, 16, 512) == 2


def _tiled_substep(x: torch.Tensor, w: torch.Tensor, g: int, rule,
                   threads: int = 128) -> torch.Tensor:
    """One substep as the Hopper design orders its arithmetic, on windows
    (nb, E, E, E) or (C, nb, E, E, E): columns of nz sites along k
    (:func:`_column_depth` at the thread block's ``threads``; the last
    column moved back to end at O), each streaming the window's k-planes in
    increasing order into the live accumulators whose dk that plane is, in
    di, dj order."""
    multi = x.ndim == 5
    u = x[0] if multi else x
    nb, E = u.shape[0], u.shape[-1]
    K, O = 2 * g + 1, E - 2 * g
    nz = _column_depth(g, O, threads)
    nzg = -(-O // nz)
    tap = torch.empty((nb, O, O, O))
    for zg in range(nzg):
        z0 = min(zg * nz, O - nz)
        acc = [torch.zeros((nb, O, O)) for _ in range(nz)]
        for p in range(nz + 2 * g):
            plane = u[:, z0 + p]
            for j in range(nz):
                dk = p - j
                if 0 <= dk < K:
                    for di in range(K):
                        for dj in range(K):
                            acc[j] = acc[j] + w[dk, di, dj] * plane[:, di:di + O, dj:dj + O]
        for j in range(nz):
            tap[:, z0 + j] = acc[j]
    centre = x[..., g:-g, g:-g, g:-g]
    if rule.name == "jacobi":
        return _jacobi_by_product(centre + tap, g)
    if multi:
        return rule.apply(centre, torch.stack([tap, tap]), g)
    return rule.apply(centre, tap, g)


def _tiled_fused(store, w, nbr, bnd, *, g, S, rule, bc):
    x = tref.assemble_halo_ref(store, nbr, S * g)
    r = get_rule(rule)
    for step in range(S):
        if bc.clamped:
            x = apply_window_bc(x, bnd, g * (S - step), bc)
        x = _tiled_substep(x, w, g, r)
    return x


@pytest.mark.parametrize("bc", BCS)
@pytest.mark.parametrize("rule", RULES)
def test_tiled_accumulation_order_is_bit_exact(rule, bc):
    """The register-tiled order of csrc/stencil3d_sm90.cu, emulated in
    plain PyTorch at T=8 (M=16) with g=1, S ∈ {1, 2, 4}, and g=2, S ∈ {1,
    2}, random weights: bit-equal to ref.stencil_fused_ref, and to the JAX
    package's oracle as the other tests hold it (jacobi within 1e-6)."""
    Tt, nt = 8, 2
    rng = np.random.default_rng(RULES.index(rule) * 10 + BCS.index(bc))
    for g, steps in ((1, (1, 2, 4)), (2, (1, 2))):
        s = 2 * g + 1
        w = torch.from_numpy(rng.normal(size=(s, s, s)).astype(np.float32))
        (_, _), (nbr, bnd) = tables("hilbert", nt, bc)
        nbr, bnd = to_torch(nbr), to_torch(bnd)
        bcs = tbnd.as_boundary(boundary(tbnd, bc))
        for S in steps:
            store = torch.from_numpy(random_store(rule, nt ** 3, Tt, seed=S + 3 * g))
            got = _tiled_fused(store, w, nbr, bnd, g=g, S=S, rule=rule, bc=bcs)
            want = tref.stencil_fused_ref(store, w, nbr, S=S, rule=rule, bc=bcs, bnd=bnd)
            assert torch.equal(got, want), (rule, bc, g, S)
            if g == 1:
                plain = tref.stencil_fused_ref(store, uniform_weights(1, "cpu"), nbr,
                                               S=S, rule=rule, bc=bcs, bnd=bnd)
                tiled = _tiled_fused(store, uniform_weights(1, "cpu"), nbr, bnd, g=1,
                                     S=S, rule=rule, bc=bcs)
                assert torch.equal(tiled, plain)
                assert_matches(tiled, jax_fused(store.numpy(), "hilbert", nt, bc, S, rule),
                               rule, (rule, bc, S))


def _group_fused(store, w, nbr, *, g, S, rule):
    """The group design in plain PyTorch over a periodic cube: each row of
    the group table cuts its (2T+2Sg)³ window from its 4×4×4 window
    blocks (per axis the last S·g planes of block 0, all of blocks 1 and 2,
    the first S·g of block 3), runs the S shrinking substeps in the
    kernel's column order at 512 threads, and writes the 2T tile's eight
    blocks to the row's output ids."""
    groups = tnbr.group_table(nbr)
    multi = store.ndim == 5
    st = store if multi else store[None]
    C, T, h = st.shape[0], st.shape[-1], S * g
    ids = groups[:, :tnbr.GROUP_WINDOW].long().reshape(-1, 4, 4, 4)
    ng = ids.shape[0]
    whole = st[:, ids].permute(0, 1, 2, 5, 3, 6, 4, 7).reshape(C, ng, 4 * T, 4 * T, 4 * T)
    x = whole[..., T - h:3 * T + h, T - h:3 * T + h, T - h:3 * T + h]
    x = x if multi else x[0]
    r = get_rule(rule)
    for _ in range(S):
        x = _tiled_substep(x, w, g, r, threads=512)
    tile = (x if multi else x[None]).reshape(C, ng, 2, T, 2, T, 2, T)
    blocks = tile.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(C, ng * 8, T, T, T)
    out = torch.full_like(st, float("nan"))
    out[:, groups[:, tnbr.GROUP_WINDOW:].long().flatten()] = blocks
    return out if multi else out[0]


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("rule", ["gol", "wave"])
def test_group_tile_order_is_bit_exact(rule, S):
    """The group design's window and order of the arithmetic, emulated at
    M=32 (eight groups of T=8 blocks) on every block curve, g=1 with
    random weights but for gol, and g=2 at S/2: bit-equal to
    ref.stencil_fused_ref, so to the block design."""
    Tt, nt = 8, 4
    rng = np.random.default_rng(10 * S + RULES.index(rule))
    for kind in KINDS:
        nbr = tnbr.neighbor_table_device(kind, nt, device="cpu")
        for g, steps in ((1, S), (2, S // 2)):
            s = 2 * g + 1
            w = uniform_weights(g, "cpu") if rule == "gol" else torch.from_numpy(
                rng.normal(size=(s, s, s)).astype(np.float32))
            store = torch.from_numpy(random_store(rule, nt ** 3, Tt, seed=S + 5 * g))
            assert tk.fused_design(Tt, g, steps, store.ndim - 3, cube=True) == "sm90_group"
            got = _group_fused(store, w, nbr, g=g, S=steps, rule=rule)
            want = tref.stencil_fused_ref(store, w, nbr, S=steps, rule=rule)
            assert torch.equal(got, want), (kind, g, steps)
