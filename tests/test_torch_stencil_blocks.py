"""The repack form's tap sum, ``stencil_sum_blocks``: its wrapper on f32,
bf16, f16 and fp8 blocks (the plain version, on CPU tensors) against the JAX
package's Pallas kernel in interpret mode; the pure function that picks
its CUDA design; and plain emulations of the Hopper design
(csrc/stencil3d_blocks_sm90.cu): its shared-memory layout, the schedule
of its ring of bulk copies, and its column order of the arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_oracle import FP8, fp8_pair, fp8_values, same_bits, to_torch
from repro.kernels import stencil3d as jk
from repro.kernels.ops import _build_uniform_weights
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stencil3d as tk

HALF = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
        "float16": (jnp.float16, torch.float16)}
# the reference's own cases (tests/test_kernels.py)
REF_CASES = [(1, 4), (1, 8), (2, 4), (3, 2)]


def _half_blocks(g, T, dtype, seed):
    """The same half-precision blocks in both packages (f32 normals rounded
    once, to nearest even, by each), and their f32 values."""
    W = T + 2 * g
    x = np.random.default_rng(seed).normal(size=(6, W, W, W)).astype(np.float32)
    jdt, tdt = HALF[dtype]
    jb, tb = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    np.testing.assert_array_equal(np.asarray(jb.astype(jnp.float32)), tb.float().numpy())
    return jb, tb


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("g,T", REF_CASES)
def test_half_blocks_match_pallas_kernel(g, T, dtype):
    """bf16 and f16 blocks with the neighbour-count weights (every product
    exact, as in the f32 case of test_torch_stencil_pallas.py): bit-equal
    to the JAX package's kernel, f32 out."""
    jb, tb = _half_blocks(g, T, dtype, seed=10 * g + T)
    w = _build_uniform_weights(g)
    want = jk.stencil_sum_blocks(jb, jnp.asarray(w), g=g, interpret=True)
    got = tk.stencil_sum_blocks(tb, to_torch(w), g=g)
    assert got.dtype == torch.float32 and got.shape == (6, T, T, T)
    assert torch.equal(got, to_torch(want))


@pytest.mark.parametrize("dtype", sorted(HALF))
@pytest.mark.parametrize("g,T", REF_CASES)
def test_half_blocks_with_random_weights_match_pallas_kernel(g, T, dtype):
    """Random weights: XLA on the CPU contracts the JAX side's multiply and
    add into fused multiply-adds (the f32 case differs from the plain
    version in the same way), so each of the 2·(2g+1)³ roundings on either
    side may differ by half a unit of its partial sum. The tolerance is
    that bound, (2g+1)³·2^-22 times the sum of |w·x| at each site; the
    CUDA kernels are held bit-equal to the plain version on the card."""
    jb, tb = _half_blocks(g, T, dtype, seed=100 + 10 * g + T)
    s = 2 * g + 1
    w = np.random.default_rng(g * T).normal(size=(s, s, s)).astype(np.float32)
    want = to_torch(jk.stencil_sum_blocks(jb, jnp.asarray(w), g=g, interpret=True))
    got = tk.stencil_sum_blocks(tb, to_torch(w), g=g)
    scale = tref.stencil_sum_ref(tb.float().abs(), to_torch(np.abs(w)))
    assert bool(((got - want).abs() <= s ** 3 * 2.0 ** -22 * scale).all())


@pytest.mark.parametrize("dtype", FP8)
@pytest.mark.parametrize("g,T", REF_CASES)
def test_fp8_blocks_match_pallas_kernel(g, T, dtype):
    """fp8 blocks holding 440–500 and NaN, neighbour-count weights: f32
    out, bit-equal to the JAX package's kernel and NaN where it is."""
    W = T + 2 * g
    jb, tb = fp8_pair(fp8_values((6, W, W, W), seed=20 * g + T), dtype)
    w = _build_uniform_weights(g)
    want = jk.stencil_sum_blocks(jb, jnp.asarray(w), g=g, interpret=True)
    got = tk.stencil_sum_blocks(tb, to_torch(w), g=g)
    assert got.dtype == torch.float32 and got.shape == (6, T, T, T)
    assert same_bits(got, want)


@pytest.mark.parametrize("T,g,dtype,want", [
    (8, 1, torch.float32, "sm90"),    # Gol3d.run's repack path (CHIP_REPACK)
    (8, 1, torch.bfloat16, "sm90"),
    (8, 1, torch.float16, "sm90"),
    (8, 2, torch.float32, "sm90"),
    (16, 1, torch.bfloat16, "sm90"),
    (16, 2, torch.float32, "sm90"),
    (16, 2, torch.float16, "sm90"),
    (4, 1, torch.float32, "simple"),   # T outside {8, 16}
    (32, 1, torch.float32, "simple"),
    (8, 3, torch.float32, "simple"),   # g outside {1, 2}
    (16, 4, torch.bfloat16, "simple"),
    (8, 1, torch.float64, "simple"),   # no kernel takes it; the wrapper raises
    (8, 2, torch.float8_e4m3fn, "simple"),  # fp8 takes the first design
    (16, 2, torch.float8_e5m2, "simple"),
])
def test_blocks_design_is_a_function_of_shape_and_dtype(T, g, dtype, want):
    assert tk.blocks_design(T, g, dtype) == want


def test_blocks_design_over_its_whole_domain():
    """sm90 exactly where csrc/stencil3d_blocks_sm90.cu has an instance:
    T ∈ {8, 16}, g ∈ {1, 2}, f32, bf16 or f16, one (T+2g)³ window a
    multiple of 16 bytes and the ring within the shared memory of one
    thread block: all 12 instances the source builds. fp8 blocks, which
    the kernels take, go to the first design."""
    picked = []
    hopper = (torch.float32, torch.bfloat16, torch.float16)
    for T in range(1, 33):
        for g in range(1, 5):
            for dtype in hopper + (torch.float8_e4m3fn, torch.float8_e5m2,
                                   torch.float64, torch.int32):
                design = tk.blocks_design(T, g, dtype)
                assert design in ("sm90", "simple")
                item = torch.empty((), dtype=dtype).element_size()
                want = (T in (8, 16) and g in (1, 2) and dtype in hopper
                        and (T + 2 * g) ** 3 * item % 16 == 0
                        and tk.blocks_sm90_smem_bytes(T, g, item) <= 232_448)
                assert (design == "sm90") == want, (T, g, dtype)
                if want:
                    picked.append((T, g, dtype))
    assert len(picked) == 12


def test_blocks_sm90_smem_model_matches_the_kernel_layout():
    """A ring of STAGES windows in the blocks' dtype plus an 8-byte
    mbarrier per stage (Plan<T, G, ITEM> in the source): two rounds of
    R = 4 blocks at T=8, four stages of one block at T=16."""
    assert tk._blocks_plan(8) == (4, 8) and tk._blocks_plan(16) == (1, 4)
    assert tk.blocks_sm90_smem_bytes(8, 1) == 8 * 4000 + 64
    assert tk.blocks_sm90_smem_bytes(8, 1, 2) == 8 * 2000 + 64
    assert tk.blocks_sm90_smem_bytes(8, 2) == 8 * 12 ** 3 * 4 + 64
    assert tk.blocks_sm90_smem_bytes(16, 1) == 4 * 18 ** 3 * 4 + 32
    assert tk.blocks_sm90_smem_bytes(16, 2) == 128_032 <= tk.SMEM_LIMIT_BYTES
    # every window of the domain is whole 16-byte pieces of a bulk copy
    for T in (8, 16):
        for g in (1, 2):
            assert (T + 2 * g) ** 3 * 2 % 16 == 0


def _ring_schedule(nb: int, grid: int, T: int) -> list[int]:
    """The control flow of blocks_sm90_kernel in plain Python: thread
    block i walks blocks [nb·i/grid, nb·(i+1)/grid) R at a time; block n
    of its run lands in stage n % STAGES, in that stage's (n // STAGES)-th
    use, and is consumed after waiting on that use's phase parity. Checks
    that every wait finds its own block landed and not yet overwritten,
    and returns the blocks in the order they were computed."""
    R, stages = tk._blocks_plan(T)
    done = []
    for i in range(grid):
        begin, end = nb * i // grid, nb * (i + 1) // grid
        holds = [None] * stages     # the block each stage holds
        landed = [0] * stages       # completed phases of its barrier
        pending = [False] * stages  # a landed block not yet consumed

        def issue(n):
            s = n % stages
            assert not pending[s], "a stage was refilled before it was read"
            holds[s], pending[s] = begin + n, True
            landed[s] += 1

        for n in range(min(stages, end - begin)):
            issue(n)
        for b0 in range(begin, end, R):
            for r in range(R):
                b = b0 + r
                if b < end:
                    n = b - begin
                    s, use = n % stages, n // stages
                    # try_wait.parity(use & 1) passes once phase `use` is done,
                    # and the protocol keeps the barrier within one phase of it
                    assert landed[s] == use + 1 and holds[s] == b
                    done.append(b)
            for r in range(R):  # the whole round is read before the refill
                if b0 + r < end:
                    pending[(b0 + r - begin) % stages] = False
            for q in range(R):
                bn = b0 + q + stages
                if bn < end:
                    issue(bn - begin)
    return done


@pytest.mark.parametrize("T", [8, 16])
@pytest.mark.parametrize("nb,sms_x_per", [(1, 528), (7, 528), (64, 528),
                                          (4096, 528), (4097, 264), (512, 3)])
def test_ring_schedule_computes_every_block_once(T, nb, sms_x_per):
    """The launch's grid (as many thread blocks as fit, no more than there
    are rounds) and the ring's schedule cover each block exactly once, in
    increasing order within each thread block's contiguous run."""
    R, _ = tk._blocks_plan(T)
    grid = min(-(-nb // R), sms_x_per)
    done = _ring_schedule(nb, grid, T)
    assert done == list(range(nb))


def _column_emulation(blocks: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """csrc/stencil3d_blocks_sm90.cu's arithmetic in plain PyTorch: the
    output in columns of NZ = 4 sites along k; each column streams its
    window's k-planes in increasing order, each plane row by row (di), and
    adds the row, widened to f32, to every live accumulator whose dk that
    plane is, dj innermost."""
    nb, W = blocks.shape[0], blocks.shape[1]
    K = w.shape[0]
    g = (K - 1) // 2
    T = W - 2 * g
    x = blocks.float()
    out = torch.empty((nb, T, T, T))
    for z0 in range(0, T, 4):
        acc = [torch.zeros((nb, T, T)) for _ in range(4)]
        for p in range(4 + 2 * g):
            for di in range(K):
                row = x[:, z0 + p, di:di + T, :]
                for j in range(4):
                    dk = p - j
                    if 0 <= dk < K:
                        for dj in range(K):
                            acc[j] = acc[j] + w[dk, di, dj] * row[:, :, dj:dj + T]
        for j in range(4):
            out[:, z0 + j] = acc[j]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("T,g", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_column_order_is_bit_exact(T, g, dtype):
    """The Hopper design's order of the arithmetic, at every instance it
    builds, with random weights: bit-equal to the plain version (and so to
    the first design, which sums each site in dk, di, dj order too)."""
    rng = np.random.default_rng(T + g)
    W, s = T + 2 * g, 2 * g + 1
    blocks = torch.from_numpy(rng.normal(size=(3, W, W, W)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.normal(size=(s, s, s)).astype(np.float32))
    assert tk.blocks_design(T, g, dtype) == "sm90"
    assert torch.equal(_column_emulation(blocks, w), tref.stencil_sum_ref(blocks, w))


def test_blocks_wrapper_on_cpu_counts_no_design_and_takes_f32_out():
    W = 10
    blocks = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, W, W, W)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(_build_uniform_weights(1))
    before = dict(_build.BLOCKS_DESIGN_LAUNCHES), _build.LAUNCHES["stencil_sum_blocks"]
    out = torch.full((4, 8, 8, 8), float("nan"))
    got = tk.stencil_sum_blocks(blocks, w, g=1, out=out)
    assert got is out and torch.equal(out, tref.stencil_sum_ref(blocks, w))
    assert (dict(_build.BLOCKS_DESIGN_LAUNCHES),
            _build.LAUNCHES["stencil_sum_blocks"]) == before
    with pytest.raises(TypeError, match="float32"):
        tk.stencil_sum_blocks(blocks, w, g=1, out=out.to(torch.bfloat16))
