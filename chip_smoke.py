#!/usr/bin/env python3
"""Drive the torch port on one CUDA card and check it against its plain
versions.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. set-up: TF32 off, the card's name and power limit, the kernels built
   from ``src/repro_torch/kernels/csrc`` with nvcc (seconds per source and
   the compiler's register/spill report per kernel instance), and the
   SASS of the Hopper flash design (``cuobjdump -sass`` from nvcc's own
   ``bin/``) must hold ``HGMMA`` (wgmma on the tensor cores) and
   ``UTMALDG`` (TMA loads), and that of its backward
   (``libflash_attn_bwd_sm90.so``) ``HGMMA``, ``UTMALDG`` and ``UBLKCP``
   (its lse and Δ by 1-D bulk copies); that of the Hopper stencil design must hold
   its 44 block kernels and 16 group kernels and no ``FFMA`` (no contracted
   multiply-add), that of
   the Hopper repack design its 12 kernels, no ``FFMA`` and ``UBLKCP``
   (its 1-D bulk copies);
2. every kernel against its plain PyTorch version on the card, at M=64
   (fault F2's fp8 stores at M=256 too):
   4 orderings × S ∈ {1, 2, 4} × {gol, jacobi, wave} × {periodic,
   dirichlet, neumann0, mixed}, plus g=2 with T=8, S=2, and the resident
   and repack tap sums against each other and their plain versions; every
   instance of the Hopper stencil design (``fused_design``: T ∈ {8, 16},
   g ∈ {1, 2}, S·g | T, C ∈ {1, 2} where it fits) under each of its rules
   and the four boundaries at M=32, random weights but for gol, also
   forced with and without its overlap; every instance of its group
   design (``fused_design(..., cube=True)``: T=8, S·g ≥ 2) under each of
   its rules on every block curve at M=32 and M=128 (3 or 4 groups a
   thread block), periodic, launched by the
   wrapper and the block design forced beside it, and the wave cells' S=4
   at M=256 on the Hilbert and row-major stores; ``stencil_sum_blocks`` on f32,
   bf16 and f16 blocks for each (T, g) above, with the neighbour count's
   and random weights, under the design ``blocks_design`` gives and
   forced onto the first design where the Hopper design runs; fault F2:
   the fused step on bf16 and f16 stores (gol and wave, periodic and
   neumann0, S ∈ {1, 2}) and the resident sum on them, all of the first
   design; F2 in fp8: the fused step (gol, jacobi, wave; periodic and
   neumann0; S ∈ {1, 2} at M=64, and gol and jacobi at M=256, S=4), the
   resident sum and the repack sum on float8_e4m3fn and float8_e5m2 stores
   holding ±[440, 480] and NaN, bit-equal to the plain version wherever it
   is a number and NaN where it is NaN (XLA's rounding: e4m3fn above 464
   is NaN), all of the first design; every fused, resident and repack
   case asserts the design
   that ran it, by the per-design launch count; the
   fused kernel on extended stores (core + shell blocks filled by the
   distributed path's own exchange and scatter, 2×2×2 local mesh of M=64
   shards) for S ∈ {1, 2, 4} × {gol, wave} × {periodic, neumann0, mixed};
   ``gather_rows`` on the six deep faces (h ∈ {1, 2, 4}) of the M=256,
   T=8 block store under the four block curves, in f32, plus bf16, int32
   and a stacked (2, n) store — every comparison bit-exact (tolerance 0);
   ``flash_attention_fwd``, whose two designs ``flash_design`` picks
   (each case asserts which one ran, by the per-design launch count): the
   Hopper design (wgmma, TMA) at the prefill's shape (the folded GQA
   tensors of B=4, S=2048: BH=60, D=64, bf16, causal, 128-blocks) under
   the row-major, Morton and Hilbert schedules, and under all three on a
   bf16 case for each of its instances (D ∈ {64, 128} × block_q, block_k
   ∈ {64, 128}), with Sq > Sk (rows with no key, in an unvisited q block
   and inside a visited one), Sq < Sk, and non-causal; the simple design
   on the JAX package's test shapes (f32, causal and full, Sq < Sk), with
   Sq > Sk, D=40 and 48-blocks, D=96 and D=128 in f32, and one bf16 case
   (D=128, 64×32 blocks, its widest build); the simple design at the
   blocks ``ops._pick_block`` gives S ∈ {12, 24, 100} from 128 (12, 24
   and 100), causal and not, in f32 and bf16, and at D=12 (padded to 16);
   the simple design at D ∈ {160, 256} (fault F1: two threads a q row),
   f32 and bf16, causal and not, blocks 64 and 128; fault F3, f16 and both
   fp8 dtypes at BH=60, S=2048, D=64 and at smaller shapes (D=40 padded,
   Sq > Sk, non-causal), and F1 up to D=1024: D ∈ {320, 512, 1024} at
   BH=16, S=2048 in bf16 and f32, and three small wide cases; F1 above
   1024, the wide instance: D ∈ {1152, 2048, 4096} at BH=4, S=256 in f32
   and bf16, causal and not, and D=1100 (f16) and D=2048 (fp8); F4, more
   folded heads than a grid has rows: BH=65,540 at S=64, D=64 in both
   designs (bf16 with 64-blocks on the Hopper design, f32 on the simple
   one); and one launch at S=32768,
   BH=15 whose last 256 rows must equal the plain version on those
   queries (the diagonal is aligned to the end) — within one bf16 unit in
   the last place (|d| <= 1e-5 + 2^-7 |plain|) for bf16, within one unit
   in the last place of the plain value plus 1e-5 for f16 and fp8, and
   1e-5 (relative and absolute) for f32, and the largest difference
   between schedules;
3. the main paths at full size (``repro_torch.configs.gol3d.CHIP_*``),
   each with the launch counts set to 0 just before and read just after,
   and every fused, resident and repack launch of a Hopper design:
   ``Gol3d.run_resident(16)`` at M=256, T=8, S=4 for the four orderings
   (must equal ``reference_run(16)``; 4 fused launches each); the wave
   pipeline at M=256, S=2, neumann0 (8 steps of ``fields_step_ref``); the
   repack path ``Gol3d.run(2)`` at M=128 (both launches of the Hopper
   repack design); the resident tap sum
   ``stencil_sum_resident`` on the M=256 store; the distributed path
   ``Gol3d.run_distributed(mesh, 16)`` at global M=256, S=4, for the four
   orderings on each mesh of ``CHIP_MESHES`` (1×1×1: one M=256 shard;
   2×2×2: eight M=128 shards held by this process on the one card; must
   equal ``reference_run(16)``; per shard ⌈16/4⌉ fused launches and six
   ``gather_rows`` launches a round), and the wave pipeline on 2×2×2
   under mixed(k=neumann0), K=8, S=2 (8 steps of ``fields_step_ref``);
   the slice, the checkpointed main path in a temporary directory removed
   at the end: ``CheckpointedRun`` over ``CHIP_MAIN`` (M=256, Hilbert,
   T=8, S=4) for K=16 with a checkpoint every 4 steps, equal to
   ``Gol3d.run_resident(16)`` from the same state with one fused launch per
   S-deep chunk; killed at step 6 and resumed onto Morton, T=16, S=2; the
   newest checkpoint bit-flipped, quarantined and the one before restored;
   NaN poisoned at step 5 of a jacobi run (``RunHealthError``, last good
   step 4); ``python -m repro_torch.launch.faults`` killed by ``os._exit``
   (exit 17) and resumed by a second process to run 1's crc; and
   ``python -m repro_torch.launch.elastic --stencil`` from eight M=128
   shards on a local 2×2×2 mesh to one M=256 shard, bit-exact (its
   launches read from its output: fused and ``gather_rows``); then the
   checkpointed run's ms per timestep against the plain run in turns,
   each part of one checkpoint (unblockize, device->host copy, two crc32s,
   health guard, npz write, fsync) and of one restore (read, crc verify,
   blockize) alone, the measured checkpoint share of an interval beside
   ``checkpoint_traffic_fraction(256, 8, 1, 4, S=4)`` = 0.1818, and the
   interval at which a checkpoint would be half the wall;
   the slice of this round, the ROI-query service (``CHIP_ROI_*``):
   ``CHIP_MAIN`` run 16 steps from the faults CLI's initial state
   (4 fused launches, all of the Hopper design, equal to the checkpoint
   slice's ``Gol3d.run_resident``), unblockized on the card and blockized
   along each of the four orderings; per ordering the device->host copy of
   the 64 MiB store and the service's manifest (32,768 crc32s) on the host
   clock, then the benchmark's ROI suite (octant, octant_hi, slab, tile,
   viewport): ``roi_model``'s ranges, blocks, bytes and utilization, query
   ms with a cold cache (a fresh service) and a warm one (median of 5),
   fetches, hits and misses, every payload bit-equal to the dense cube's
   slice, and Hilbert's range count below row-major's on every ROI; one
   query on the wave phase's C=2 store; the fault matrix (failed and
   bit-flipped fetches recovered and exhausted, a poisoned cache entry
   quarantined, a fetch slower than the deadline, load shed at
   ``max_in_flight=1`` under ``query_batch``), every outcome typed and
   every served voxel exact; the CLI's demo in this process, then
   ``python -m repro_torch.launch.serve --stencil --M 256 --faults`` as a
   subprocess, as given and with a 2 s deadline and 12 queries in flight
   (``SERVE_DONE``, its 4 fused launches read from its output);
   full-width ``smollm-360m`` (weights from a seeded ``torch.Generator``):
   ``Model.prefill`` at B=4, S=2048 with ``use_flash_kernel`` (exactly
   one ``flash_attention_fwd`` launch per layer, every one of the Hopper
   design; logits within 0.1 of the
   prefill through plain ``masked_sdpa`` and of the prefill with the
   kernel's plain version in its place; then, with the plain version
   beside the kernel, every layer's launch within one bf16 unit of the
   plain version on that layer's own q, k, v, and the prefill in f32
   activations within 1e-4 of its plain-version twin), then ``greedy_decode`` of
   32 new tokens for 4 requests of 16-token prompts (no kernel launch;
   4×32 tokens; decode's logits at the last prompt position within 0.1
   of the prefill's, argmax agreement reported);
4. timings with CUDA events (median of repeats after a warm-up), and for
   the µs-scale gather and pack calls their device time from a profiler
   trace (CUDA events instead, and said so, when traces hold no device
   events): each kernel at its main-path shape beside its plain version
   (the fused step and the resident sum in both designs, and the Hopper
   design forced with and without its overlap, in turns), a single
   PyTorch call that computes the same function where there is one
   (conv3d, TF32 off; index_select for the gather; yardsticks the port
   never calls) and the least time the card could take for the
   function's own work (bytes over 3.35 TB/s or f32 operations over
   67 TFLOP/s, whichever is larger; the halo sites the fused design
   recomputes are reported apart, as a model of the design's work);
   ms/timestep of the main path per ordering and per block curve (three
   passes, for the run-to-run spread); of the
   distributed path per ordering and mesh, with its exchange (pack,
   shift and scatter) beside its fused kernels; and the paper's exchange
   question: rows fetched and ms per face when packing the six faces of
   a path-ordered M=256 cube under each ordering; the Hopper flash design
   per schedule at S=2048 (BH=60) and S=32768 (BH=15) beside its plain
   version, the simple design on the same bf16 tensors, and SDPA (the
   folded tensors viewed as (B, 15, S, D); a yardstick the port never
   calls), against the bound of its operations at 989 TFLOP/s (bf16),
   with TFLOP/s; the simple design in f32 at S=2048 against 67 TFLOP/s,
   and at D=256 (BH=16, S=2048, bf16) beside SDPA and its bound;
   ``stencil_sum_blocks`` in both designs, in turns, at M=128 and at
   M=256 in f32 and bf16, beside conv3d and its bound; the three stencil
   kernels on fp8 stores at M=256 beside their plain versions, their
   bounds and conv3d in f16; the simple flash design in f16 and fp8 at
   BH=60, S=2048, D=64 (SDPA in f16 beside f16; no PyTorch call takes
   fp8) and at D ∈ {320, 512, 1024} (BH=16, S=2048) in bf16 and f32
   beside SDPA, each against its bound; the wide instance at D ∈ {1152,
   2048, 4096} (BH=4, S=256) and both designs at BH=65,540 (S=64, D=64)
   in bf16 and f32, beside the plain version, SDPA and the bound; the
   repack path's
   ms per timestep (host clock) and the kernel's share of it;
   prefill ms and tokens/s
   with the kernel and with plain attention, decode ms per step and
   tokens/s (median of 5 after a warm-up), and the kernel's share of the
   prefill's device time (profiler);
5. the training path (``train_phase``, sizes ``CHIP_TRAIN_*`` in
   ``configs/smollm_360m.py``): ``make_train_step`` on full-width
   ``smollm-360m`` (32 layers, bf16 activations, f32 master weights,
   ``use_flash_kernel``, ``remat=True``) at B=4, S=4096: 64
   ``flash_attention_fwd`` launches a step, every one of the Hopper design
   (32 forward, 32 in the remat recompute), and 32 ``flash_attention_bwd``
   launches, every one of the Hopper backward (counted as a main path), and
   no call of ``kernels.ref``'s attention functions (``REF_ATTENTION``) in
   that step; the same step with both kernels' plain versions in their
   place (loss within 2e-4 relative, gradient norm within 1e-3), and again
   from the same state (bit-equal or not, reported); ``microbatches=2``
   (loss within 2e-4);
   4 layers in f32 activations at B=1, S=2048 on the simple designs (8
   forward and 4 backward launches; loss within 1e-5 relative, every
   gradient leaf within a relative L2 error of 1e-4 of the plain
   versions'); a SMOKE ``Trainer`` of 4 steps killed
   after its checkpoint at step 2 and resumed, bit-equal to the unbroken
   run under ``torch.use_deterministic_algorithms(True)``, in a temporary
   directory removed at the end; ``python -m repro_torch.launch.train
   --smoke`` as a subprocess; then ms per step and tokens/s (median of 3
   after a warm-up), peak memory, and one profiled step: device busy,
   flash forward's, flash backward's, the GEMMs' shares and AdamW's time;
   then the kernel alone at the step's shape (BH=60, S=4096, D=64) held
   against its plain version (one bf16 unit in the last place plus 1e-5)
   and timed beside it and SDPA. Its readings go into the kernels line
   under ``flash_attention_fwd.training``. Last ``flash_attention_bwd``
   alone (``bwd_checks``) from the forward kernel's o (held against the
   plain forward) and lse: the Hopper backward at the step's shape, at
   BH=96, S=2048, D=128 and at the train example's BH=60, S=256, D=64, dq,
   dk and dv each within a relative L2 error of 1e-2 of the plain version; the
   simple backward in f32 and f16 at D=64, bf16 at D=256, float8_e4m3fn at
   D=64 and f32 at D=1152 (S=256, its f32 workspace), f32 within 1e-5 and
   the others within one unit of their type; each timed beside its plain
   version, ``aten._scaled_dot_product_flash_attention_backward`` (bf16 and
   f16; a yardstick the port never calls) and its bound; the
   ``flash_attention_bwd`` row of the kernels line. Then the same step over a torch
   device mesh (``mesh_phase``): a one-rank nccl ``DeviceMesh`` (1, 1)
   ("data", "model"), every parameter and AdamW leaf a DTensor placed by
   ``partition_specs`` -> ``sanitize_specs``, the residual pinned by
   ``act_spec``; three steps against the unsharded step (the same bf16
   gates; bit-equal reported), 64 ``sm90`` forward and 32 ``sm90``
   backward launches a step (counted as a main path), the sharded tree (params, m, v) checkpointed and restored
   with ``shardings=`` bit for bit, then ms per step, peak memory and one
   profiled step's busy share beside the unsharded step's; its readings go
   under ``flash_attention_fwd.mesh``. With that mesh up, the dry run
   (``dryrun_check``): ``launch.dryrun.run_cell`` counts three full-width
   smollm-360m cells on the card (``DRYRUN_CELLS``: train B=4, S=4096;
   prefill B=4, S=2048; decode B=4 at 2048 positions; flash=0) and runs
   each once more for its ms and peak memory beside its roofline terms; a
   child process without CUDA counts the same cells on meta (flops, flops
   by kind, bytes, collective bytes and argument bytes equal to the
   card's as integers) and runs the production CLI; the prefill at
   flash=1 charges 32 ``flash_attention_fwd`` launches (counted as a main
   path: 64, the step before the counted one included); its readings go
   under ``flash_attention_fwd.dryrun``. Ranks sharing the one card have no
   backend (nccl refuses them, gloo's DTensor collectives crash on CUDA
   tensors), so the elastic CLI's 8 ranks are not run on the card;
6. the other LMs (``archs_phase``, the config modules of
   ``ARCH_MODULES``, sizes ``CHIP_*`` in each), one at a time at full
   width with seeded weights, bf16 activations and f32 weights, each freed
   before the next, cut in depth where the script's time limit or one
   card's memory asks it: gemma3-1b (12 of 26 layers), phi4-mini-3.8b
   (8 of 32), deepseek-coder-33b (8 of 62: its f32 weights would take
   133 GB), deepseek-moe-16b (8 of 28) and deepseek-v2-lite-16b (8 of
   27). Each: a
   counted ``Model.prefill`` at B=4, S=2048 (one ``sm90``
   ``flash_attention_fwd`` launch a layer where the attention is GQA
   without a window: phi4, coder and deepseek-moe-16b; none for
   gemma3-1b's windows and MLA; counted as a main path),
   ``greedy_decode`` of 32 new tokens for 4 requests (no launch), decode's
   logits at the last prompt position against the prefill's in f32
   activations (within 1e-4; in bf16 reported), prefill ms and tokens/s
   (median of 5 after a warm-up) and decode ms per step (median of 3),
   peak memory.
   Where flash runs: the kernel alone at that prefill's folded shape
   (BH=96, 224 and 64; S=2048, D=128, bf16, causal) against its plain
   version (one bf16 unit in the last place plus 1e-5), timed beside it,
   SDPA and the bound of its operations at 989 TFLOP/s; for phi4 and
   coder, 4 layers in f32 activations on the simple design against the
   same prefill with the plain version (1e-4). gemma3-1b: 6 layers (five
   local, one global) decoded 520 steps past the 512-position window
   against the prefill (1e-4 in f32, 0.1 in bf16), and temperature
   sampling (the step's token equal to the host's argmax of the same
   logits / 0.7 plus the given Gumbel noise; one generator seed, the same
   tokens twice). The MoE archs: the share of assignments the prefill
   drops at the config's capacity factor (1.25), decode against prefill
   at a capacity factor where none drops, and 2 layers (the dense one and
   one MoE layer) in f32 at B=1, S=256 on the card against the same on
   the CPU (1e-4). mamba2-2.7b (16 of 64 layers: no kernel), zamba2-1.2b
   (12 of 38 Mamba2 layers; its shared GQA block's 2 applications there
   are its flash launches, BH=128, D=64), whisper-small (12 + 12 layers, frames of
   (4, 1500, 768); the decoder's 12 layers launch flash, BH=48, D=64; the
   bidirectional encoder and the cross-attention run plain softmax
   attention) and internvl2-76b (8 of 80 layers: its f32 weights would
   take 282.3 GB; 256 patches + 1792 tokens, so flash runs at Sq=2048,
   BH=256, D=128, GQA rep 8). The ssm and hybrid pair decode with the
   prefill over 256 positions (the prefill takes a multiple of the SSD
   chunk), hold one Mamba2 layer in f32 on the card against the CPU
   (1e-4), and time one ``long_500k`` decode step at B=1 (mamba2's f32
   state; zamba2's bf16 cache of 524,288 positions, logits finite);
   whisper's pair fills the cross cache from the encoder's output on the
   prompts' frames; internvl2's text-only decode is not comparable with
   its prefill, so 2 layers of its f32 prefill are held card against CPU
   (1e-4 per unit of its logits' std, 1.8). Its readings go into the
   kernels line under
   ``flash_attention_fwd.archs``;
7. the examples' torch twins (``examples_phase``), each
   ``examples/<name>.py``'s ``main`` loaded by its path and run on the
   card with the launch counts set to 0 just before and read just after:
   quickstart (``stencil_sum_blocks`` and ``gather_rows``), the stencil
   demo (``stencil_step_fused``, ``stencil_sum_blocks``, ``gather_rows``;
   its part 2 on a local 2×2×2 mesh), the serve demo (no launch) and the
   train demo ``--full`` for 10 steps, then resumed to 12 from its
   checkpoint in a temporary directory removed at the end (every flash
   launch forward and backward of the Hopper design). The gol3d, resident
   and wave finals and quickstart's packed faces bit-equal to the same
   functions on the CPU, the serve
   demo's first new tokens equal to the CPU's, the losses finite; each
   twin's launches go into its kernels' rows, under ``examples``, and
   into ``launches``.

It prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
then not 0 and no result line is printed. Without CUDA, or without the
repository beside it, it exits non-zero at once.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16 tensor cores, dense
F16_FLOP_PER_S = 989e12        # H100 SXM fp16 tensor cores, dense
FP8_FLOP_PER_S = 1979e12       # H100 SXM fp8 tensor cores, dense
SOURCES = {"stencil_step_fused": "src/repro_torch/kernels/csrc/stencil3d_sm90.cu",
           "stencil_sum_resident": "src/repro_torch/kernels/csrc/stencil3d_sm90.cu",
           "stencil_sum_blocks": "src/repro_torch/kernels/csrc/stencil3d_blocks_sm90.cu",
           "gather_rows": "src/repro_torch/kernels/csrc/sfc_gather.cu",
           "flash_attention_fwd": "src/repro_torch/kernels/csrc/flash_attn_sm90.cu",
           "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attn_bwd_sm90.cu"}
REPLACES = {"stencil_step_fused": "src/repro/kernels/stencil3d.py:296",
            "stencil_sum_resident": "src/repro/kernels/stencil3d.py:212",
            "stencil_sum_blocks": "src/repro/kernels/stencil3d.py:114",
            "gather_rows": "src/repro/kernels/sfc_gather.py:33",
            "flash_attention_fwd": "src/repro/kernels/flash_attn.py:106",
            # no Pallas backward: the custom_vjp backward that recomputes
            "flash_attention_bwd": "src/repro/kernels/ops.py:215"}
BCS = ("periodic", "dirichlet", "neumann0", "mixed")
# csrc/stencil3d_sm90.cu: 12 (T, g, S) for gol, jacobi and identity, 8 for wave
SM90_STENCIL_KERNELS = 44
# and its group design: (g, S) in {(1, 2), (1, 4), (2, 1), (2, 2)} at T=8,
# for gol, jacobi, identity and wave
SM90_GROUP_KERNELS = 16
# csrc/stencil3d_blocks_sm90.cu: (T, g) in {8, 16} x {1, 2}, f32, bf16 and f16
SM90_BLOCKS_KERNELS = 12
# the (T, g) pairs of the tap sums' checks: the Hopper designs' four, then
# two that only the first designs take
SUM_SHAPES = ((8, 1), (8, 2), (16, 1), (16, 2), (4, 1), (16, 4))
FACES = ("k0", "k1", "i0", "i1", "j0", "j1")
LINE = 64  # elements per gathered row (kops.sfc_gather_take's default)
# gather_rows launches per shard and exchange round: stencil/halo.
# exchange_shell packs k0, k1, i0, i1, j0 and j1 once each, every channel
# in one pack, under every boundary contract
PACKS_PER_SHARD = 6
FLASH_SCHEDULES = ("row_major", "morton", "hilbert")
FLASH_BLOCK = 128  # gqa_attention's blocks (models/attention.py)
# flash_attention_fwd against its plain version: f32 softmax attention in
# both, dense against online and summed in another order, so f32 outputs
# agree to 1e-5 (relative and absolute) and bf16 outputs, rounded once
# from those f32 values, by at most one bf16 unit in the last place
FLASH_F32_TOL = 1e-5
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 2.0 ** -7, 1e-5
# smollm-360m logits (std about 0.6 with these random weights) of two
# paths that round bf16 activations at other places: the flash kernel
# against plain masked_sdpa (which rounds the probabilities to bf16), and
# decode (f32 cache, one token a step) against prefill
LM_LOGIT_TOL = 0.1
# smollm-360m prefill logits in f32 activations with the flash kernel
# against the same prefill with flash_attention_ref in the kernel's place:
# the same f32 arithmetic summed in another order, and no bf16 rounding
# to turn a last-place difference into a flipped activation (in bf16 the
# two sit 0.05 apart, as far as the masked_sdpa prefill: 32 layers of
# bf16 rounding carry any flip that far)
LM_F32_LOGIT_TOL = 1e-4
# the training step with the flash kernel against the same step with its
# plain version swapped in: at full depth in bf16 the two round the
# attention output to bf16 at other places, and 32 layers carry that into
# the loss and the gradient norm. The step is bit-repeatable on the H100
# and read 2.07e-5 (loss) and 8.74e-5 (gradient norm) relative in three
# runs; the bounds sit about 10x above (microbatches=2 read 0 against the
# same loss bound). In f32 activations (4 layers) only the summation order
# differs: the loss to 1e-5 relative and every gradient leaf to a
# relative L2 error of 1e-4
TRAIN_BF16_LOSS_RTOL, TRAIN_BF16_GNORM_RTOL = 2e-4, 1e-3
# flash_attention_bwd against its plain version on the same inputs (the
# forward kernel's o and lse): the Hopper design rounds P and dS to bf16
# once each (2^-9 of a term at most), so dq, dk and dv are each held to a
# relative L2 error of 1e-2; the simple design computes in f32 as the plain
# version does, summed in another order, and rounds once: f32 within 1e-5
# relative L2, the narrower types within one unit of their type (finfo.eps)
BWD_SM90_REL_L2, BWD_F32_REL_L2 = 1e-2, 1e-5
# the Hopper backward alone: the training step's folded shape (BH, S, D),
# phi4-mini-3.8b's and deepseek-coder-33b's head dim, and the train
# example's --full microbatch (4 sequences x 15 heads, S=256: 2 kv tiles
# a row)
BWD_SM90_SHAPES = ((60, 4096, 64), (96, 2048, 128), (60, 256, 64))
# the simple backward alone: (dtype, BH, S, D); the first is the f32
# training check's shape, whose kernel it times
BWD_SIMPLE_CASES = (("float32", 15, 2048, 64), ("float16", 15, 2048, 64),
                    ("bfloat16", 16, 2048, 256), ("float8_e4m3fn", 15, 2048, 64),
                    ("float32", 4, 256, 1152))
MESH_STEPS = 3  # the mesh phase's checked (and then timed) steps
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_RTOL = 1e-5, 1e-4
# the names of GEMM kernels in a profiler trace (cuBLAS, CUTLASS)
GEMM_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.I)
# the config modules (under repro_torch.configs) archs_phase serves, in order
ARCH_MODULES = ("gemma3_1b", "phi4_mini_3p8b", "deepseek_coder_33b",
                "deepseek_moe_16b", "deepseek_v2_lite_16b", "mamba2_2p7b",
                "zamba2_1p2b", "whisper_small", "internvl2_76b")
# f32 activations on the card against the same weights and input on the
# CPU at full width (a MoE model's stages, a Mamba2 layer, the VLM's
# 2-layer prefill, there per unit of its logits' std where that is above
# 1): the same f32 arithmetic summed in other orders, as LM_F32_LOGIT_TOL
CARD_CPU_TOL = 1e-4
# a checkpoint every CKPT_INTERVAL steps on the checkpointed main path
CKPT_INTERVAL = 4

# the train twin's two runs: --full for TRAIN_EX_STEPS steps, then resumed
# from its final checkpoint to TRAIN_EX_RESUME
TRAIN_EX_STEPS, TRAIN_EX_RESUME = 10, 12


def load_example(name: str):
    """The module ``examples/<name>.py``, loaded by its path (``examples``
    is not a package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev) -> dict:
    """The four example twins' ``main`` on the card, each with the launch
    counts set to 0 just before and read just after (counted as a main
    path), against the same functions on the CPU (the plain versions):
    quickstart's three gol3d finals and three packed j0 faces (M=32,
    ``gather_rows``), and the stencil demo's resident
    (Morton, Hilbert) and wave (S=2, 4) finals bit-equal; the serve demo's
    tokens (4, 32), finite, each request's first new token equal to the
    CPU's (the share of equal tokens reported: a later token can follow a
    near tie), and no launch; the train demo ``--full`` for
    ``TRAIN_EX_STEPS`` steps, then ``--resume`` to ``TRAIN_EX_RESUME``, in
    a temporary directory removed at the end: finite losses, the resume at
    step ``TRAIN_EX_STEPS``, every flash launch forward and backward of
    the Hopper design. Each twin's own checks raise. Returns, by twin, its
    launches by kernel."""
    import torch

    from repro_torch.kernels import _build

    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    launches, seconds = {}, {}

    def run(name, argv):
        """``name``'s main(argv) on the card, counted and timed."""
        mod = load_example(name)
        _build.reset_launches()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        got = {k: n for k, n in _build.LAUNCHES.items() if n}
        mine = launches.setdefault(name, {})
        for k, n in got.items():
            mine[k] = mine.get(k, 0) + n
        designs = {what: dict(c) for what, c in (
            ("fused and resident", _build.STENCIL_DESIGN_LAUNCHES),
            ("repack", _build.BLOCKS_DESIGN_LAUNCHES),
            ("flash forward", _build.FLASH_DESIGN_LAUNCHES),
            ("flash backward", _build.FLASH_BWD_DESIGN_LAUNCHES)) if any(c.values())}
        log(f"examples {' '.join([name] + argv)}: {time.perf_counter() - t0:.1f} s, "
            f"launches {got}, by design {designs}")
        return mod, out

    def same(what, got, want):
        check(got.shape == want.shape and torch.equal(got.cpu(), want.cpu()),
              f"{what}: card != CPU")

    qs, got = run("quickstart_torch", [])
    want = qs.main(["--device", "cpu"])
    for part in ("finals", "packed"):
        for spec, w in want[part].items():
            same(f"quickstart {part} {spec}", got[part][spec], w)
    check(launches["quickstart_torch"].get("stencil_sum_blocks") == 15
          and launches["quickstart_torch"].get("gather_rows", 0) > 0,
          f"quickstart launches {launches['quickstart_torch']}")

    demo, got = run("stencil_halo_demo_torch", [])
    want = demo.resident_demo(cpu)["finals"]
    for spec in ("morton", "hilbert"):
        same(f"stencil demo resident {spec}", got["resident"]["finals"][spec],
             want[spec])
    want = demo.wave_demo(cpu)["finals"]
    for S in (2, 4):
        same(f"stencil demo wave S={S}", got["wave"]["finals"][S], want[S])
    ran = launches["stencil_halo_demo_torch"]
    check(all(ran.get(k, 0) > 0 for k in ("stencil_step_fused",
                                         "stencil_sum_blocks", "gather_rows")),
          f"stencil demo launches {ran}")

    _, got = run("serve_lm_torch", [])
    want = load_example("serve_lm_torch").main(["--device", "cpu"])["tokens"]
    tok = got["tokens"]
    check(tuple(tok.shape) == (4, 32) and bool(torch.isfinite(tok.float()).all()),
          f"serve demo tokens {tuple(tok.shape)}")
    check(torch.equal(tok[:, 0], want[:, 0]),
          f"serve demo first tokens {tok[:, 0].tolist()} != CPU {want[:, 0].tolist()}")
    check(not launches["serve_lm_torch"],
          f"serve demo launched {launches['serve_lm_torch']}")
    log(f"examples serve_lm_torch: first new token equal to the CPU's 4/4; "
        f"tokens equal {int((tok == want).sum())}/{tok.numel()}; "
        f"{got['tok_per_s']:.1f} tok/s")

    work = tempfile.mkdtemp()
    try:
        for argv, first in (
                (["--full", "--steps", str(TRAIN_EX_STEPS)], 0),
                (["--full", "--resume", "--steps", str(TRAIN_EX_RESUME)],
                 TRAIN_EX_STEPS)):
            _, r = run("train_lm_torch", argv + ["--ckpt-dir", work])
            end = TRAIN_EX_STEPS if first == 0 else TRAIN_EX_RESUME
            check(r["steps"] == list(range(first, end)),
                  f"train demo {argv}: steps {r['steps']}")
            check(all(math.isfinite(x) for x in r["losses"]),
                  f"train demo {argv}: losses {r['losses']}")
            fwd, bwd = dict(_build.FLASH_DESIGN_LAUNCHES), dict(_build.FLASH_BWD_DESIGN_LAUNCHES)
            check(fwd["sm90"] > 0 and bwd["sm90"] > 0
                  and fwd["simple"] == 0 == bwd["simple"],
                  f"train demo {argv}: flash launches by design {fwd}, backward {bwd}")
            steady = r["step_ms"][1:] or r["step_ms"]
            log(f"examples train_lm_torch {' '.join(argv)}: steps {r['steps'][0]}.."
                f"{r['steps'][-1]}, losses {[round(x, 4) for x in r['losses']]}; "
                f"ms per step {statistics.median(steady):.3f} (median after the "
                f"first; first {r['step_ms'][0]:.1f}); the steps "
                f"{sum(r['step_ms']) / 1e3:.1f} s of the run, the rest model "
                f"set-up, checkpoints and restore")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("examples: wall seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; the phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    """msg on a line of its own, after the seconds since the script began."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def in_background(fn, nice: int | None = None):
    """Start fn() on a thread of its own (at CPU priority ``nice`` where
    given: Linux sets a thread's own nice value by its id); returns a
    function that waits for it and gives fn's result, or raises what fn
    raised."""
    out = {}

    def run():
        try:
            if nice is not None:
                with contextlib.suppress(OSError):
                    os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), nice)
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised by the waiter
            out["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def result():
        thread.join()
        if "error" in out:
            raise out["error"]
        return out["value"]
    return result


def device_ms_by_name(prof) -> dict:
    """ms of device time by kernel (and copy) name in a finished profiler
    trace, summed from its raw events; ``key_averages`` builds the same
    from an event tree, which takes seconds per hundred thousand events
    (a greedy_decode's trace). The device-side span of a
    ``record_function`` range (the program's spans, ``repro_torch.trace``)
    is a user annotation, not a kernel, and is left out."""
    from torch.autograd import DeviceType

    out = {}
    for e in prof.profiler.kineto_results.events():
        annotation = getattr(e, "is_user_annotation", None)
        if e.device_type() == DeviceType.CUDA and not (annotation and annotation()):
            out[e.name()] = out.get(e.name(), 0.0) + e.duration_ns() / 1e6
    return {k: v for k, v in out.items() if v > 0}


# CPU priorities (nice values) of the work that runs while nvcc builds
# the kernels: the host arithmetic the checks need right after the build,
# then the dry run's meta count, which the mesh phase reads minutes later,
# so that the build keeps the cores it needs and the rest takes those it
# leaves idle
HOST_WORK_NICE, CHILD_NICE = 10, 19


# every child process run_cli starts, so that an exit on a failure stops
# those still running
PROCS: list = []


def run_cli(module: str, *args, timeout: float = 600) -> subprocess.CompletedProcess:
    """``python -m module args`` from the checkout's root with its ``src``
    on ``PYTHONPATH``: its exit code and output, as ``subprocess.run``
    gives them (killed after ``timeout`` seconds)."""
    proc = subprocess.Popen([sys.executable, "-m", module, *args], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    PROCS.append(proc)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def kernel_name(line: str) -> str | None:
    """The kernel and its template arguments, from the mangled name in a
    ptxas "Compiling entry function" line (None if it holds no kernel)."""
    for m in re.finditer(r"_kernel", line):
        end = m.end()
        for start in range(m.start(), 0, -1):
            digits = re.search(r"\d+$", line[:start])
            if digits and any(int(digits.group()[i:]) == end - start
                              for i in range(len(digits.group()))):
                args = line[end:].split("Ev")[0]
                args = [a or b for a, b in
                        re.findall(r"Li(\d+)E|\d+([A-Za-z_]\w*?)(?=L|E|$)", args)]
                return line[start:end] + (f"<{', '.join(args)}>" if args else "")
    return None


def plain_fwd(q, k, v, *, causal, block_q, block_k, schedule, return_lse=False):
    """``flash_attention_fwd``'s plain version with the wrapper's signature,
    to swap into ``kops.flash_attention_fwd`` (the blocks and schedule
    change nothing in it)."""
    from repro_torch.kernels import ref

    o = ref.flash_attention_ref(q, k, v, causal=causal)
    return (o, ref.flash_attention_lse_ref(q, k, causal=causal)) if return_lse else o


def plain_bwd(q, k, v, o, lse, do, *, causal, block_q, block_k):
    """``flash_attention_bwd``'s plain version with the wrapper's signature,
    to swap into ``kops.flash_attention_bwd``."""
    from repro_torch.kernels import ref

    return ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)


# the plain attention functions that the kernel steps must not call
REF_ATTENTION = ("attention_ref", "flash_attention_ref", "flash_attention_lse_ref",
                 "flash_attention_bwd_ref")


@contextlib.contextmanager
def ref_calls():
    """Within it, the calls of ``kernels.ref``'s attention functions
    (``REF_ATTENTION``) are counted in the dict it yields: each is wrapped
    in place, and restored on exit."""
    from repro_torch.kernels import ref

    calls = {n: 0 for n in REF_ATTENTION}
    real = {n: getattr(ref, n) for n in REF_ATTENTION}

    def counted(name):
        def fn(*a, **kw):
            calls[name] += 1
            return real[name](*a, **kw)
        return fn

    for n in REF_ATTENTION:
        setattr(ref, n, counted(n))
    try:
        yield calls
    finally:
        for n, fn in real.items():
            setattr(ref, n, fn)


@contextlib.contextmanager
def swapped(fwd, bwd):
    """Within it, ``kops.flash_attention_fwd`` and
    ``kops.flash_attention_bwd`` are ``fwd`` and ``bwd``."""
    from repro_torch.kernels import ops as kops

    real = kops.flash_attention_fwd, kops.flash_attention_bwd
    kops.flash_attention_fwd, kops.flash_attention_bwd = fwd, bwd
    try:
        yield
    finally:
        kops.flash_attention_fwd, kops.flash_attention_bwd = real


def events_ms(fn, reps=5, inner=5) -> float:
    """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls
    of ``fn``, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def walls_ms(fn, n=5) -> float:
    """Median over ``n`` of the host-clock ms of ``fn`` ending in a
    synchronize, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t1))
    return statistics.median(walls)


def train_phase(dev, flash_err, train_cli) -> dict:
    """The training path at full width: ``make_train_step`` on
    ``smollm-360m`` (all 32 layers, bf16 activations, f32 master weights,
    ``use_flash_kernel``, ``remat=True``) at ``CHIP_TRAIN_*``, weights from
    a seeded ``torch.Generator`` and ``TokenPipeline`` batches. Checks the
    launches (64 ``sm90`` flash launches a step: the forward and the remat
    recompute; 32 ``sm90`` backward launches) and that no plain attention
    runs in the step, the kernels against their plain versions swapped into
    ``kops.flash_attention_fwd`` and ``_bwd`` (full depth in bf16; 4 layers
    in f32 on the simple designs), ``microbatches=2``, a ``Trainer`` killed
    and resumed at SMOKE size (bit-equal under
    ``torch.use_deterministic_algorithms``) and the CLI (its process
    started earlier: ``train_cli()`` waits for it); then times steps
    and profiles one, holds the forward kernel alone at the step's shape
    against its plain version with ``flash_err``, and runs
    :func:`bwd_checks`. Returns the readings for the ``flash_attention_fwd``
    row (``launches``: the counted step's) and for the
    ``flash_attention_bwd`` row (``bwd``, ``bwd_launches``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import smollm_360m as lm_sizes
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.models import Model
    from repro_torch.train import (OptConfig, TrainConfig, Trainer,
                                   TrainerConfig, init_opt_state,
                                   make_train_step)
    from repro_torch.models.params import leaves

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    cfg = dataclasses.replace(lm_sizes.CONFIG, use_flash_kernel=True)
    B, S = lm_sizes.CHIP_TRAIN_BATCH, lm_sizes.CHIP_TRAIN_SEQ
    base_mem = torch.cuda.memory_allocated()
    model = Model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0)).requires_grad_()
    params = model.params()
    init = [p.detach().clone() for p in leaves(params)]
    opt = OptConfig(warmup_steps=1, total_steps=10)

    def batch_of(pipe, step):
        return {k: torch.from_numpy(v).to(dev)
                for k, v in pipe.batch_at(step).items()}

    pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=0)
    batch = batch_of(pipe, 0)
    kernels = kops.flash_attention_fwd, kops.flash_attention_bwd

    def fresh_step(microbatches=1, fns=kernels):
        """One step from the seeded weights and a zero optimizer state,
        with ``fns`` in ``kops.flash_attention_fwd`` and ``_bwd``: its
        metrics."""
        with torch.no_grad():
            for p, w in zip(leaves(params), init):
                p.copy_(w)
        step = make_train_step(model, TrainConfig(opt=opt,
                                                  microbatches=microbatches))
        with swapped(*fns):
            _, _, m = step(params, init_opt_state(params), batch)
        return {k: float(v) for k, v in m.items()}

    # one counted step (and no call of a plain attention in it), then the
    # same step again (is it bit-repeatable?)
    _build.reset_launches()
    with ref_calls() as plain_calls:
        got = fresh_step()
        sync()
    counts = dict(_build.LAUNCHES)
    by_design = dict(_build.FLASH_DESIGN_LAUNCHES)
    bwd_by_design = dict(_build.FLASH_BWD_DESIGN_LAUNCHES)
    n_flash, n_bwd = 2 * cfg.n_layers, cfg.n_layers
    check(counts == {**{n: 0 for n in counts}, "flash_attention_fwd": n_flash,
                     "flash_attention_bwd": n_bwd},
          f"train step launches {counts}, want {n_flash} flash_attention_fwd and "
          f"{n_bwd} flash_attention_bwd")
    check(by_design == {"sm90": n_flash, "simple": 0}
          and bwd_by_design == {"sm90": n_bwd, "simple": 0},
          f"train step flash launches by design {by_design}, backward "
          f"{bwd_by_design}, want all sm90")
    check(not any(plain_calls.values()),
          f"train step called plain attention: {plain_calls}")
    check(all(math.isfinite(x) for x in got.values()), f"train step metrics {got}")
    again = fresh_step()
    repeat = got == again
    # the kernels against their plain versions: full depth in bf16
    plain = fresh_step(fns=(plain_fwd, plain_bwd))
    loss_rel = abs(got["loss"] - plain["loss"]) / abs(plain["loss"])
    gn_rel = abs(got["grad_norm"] - plain["grad_norm"]) / plain["grad_norm"]
    check(loss_rel <= TRAIN_BF16_LOSS_RTOL,
          f"bf16 train step loss {got['loss']} vs plain {plain['loss']}")
    check(gn_rel <= TRAIN_BF16_GNORM_RTOL,
          f"bf16 train step grad norm {got['grad_norm']} vs plain {plain['grad_norm']}")
    micro = fresh_step(microbatches=2)
    micro_rel = abs(micro["loss"] - got["loss"]) / abs(got["loss"])
    check(micro_rel <= TRAIN_BF16_LOSS_RTOL,
          f"microbatches=2 loss {micro['loss']} vs {got['loss']}")
    log(f"train {cfg.name} B={B} S={S}, {cfg.n_layers} layers, bf16, remat: step launches "
        f"{counts['flash_attention_fwd']} flash_attention_fwd (by design "
        f"{by_design}) and {counts['flash_attention_bwd']} flash_attention_bwd (by "
        f"design {bwd_by_design}), calls of plain attention {plain_calls}; "
        f"loss {got['loss']:.6f}, grad norm "
        f"{got['grad_norm']:.6f}; repeated step bit-equal: {repeat}; plain "
        f"version: loss {plain['loss']:.6f} (rel {loss_rel:.3g}), grad norm "
        f"{plain['grad_norm']:.6f} (rel {gn_rel:.3g}); microbatches=2 loss "
        f"{micro['loss']:.6f} (rel {micro_rel:.3g})")

    # 4 layers in f32 activations (the simple design): loss and every
    # gradient leaf of the kernel's step against the plain version's
    cfg32 = dataclasses.replace(cfg, activation_dtype="float32",
                                n_layers=lm_sizes.CHIP_TRAIN_F32_LAYERS)
    m32 = Model(cfg32, device=dev).init(
        torch.Generator(device=dev).manual_seed(1)).requires_grad_()
    b32 = batch_of(TokenPipeline(vocab=cfg.vocab,
                                 batch=lm_sizes.CHIP_TRAIN_F32_BATCH,
                                 seq=lm_sizes.CHIP_TRAIN_F32_SEQ, seed=1), 0)
    leaves32 = leaves(m32.params())

    def grads32(fns):
        with swapped(*fns):
            loss, _ = m32.loss(b32, remat=True)
            return loss.item(), torch.autograd.grad(loss, leaves32)

    _build.reset_launches()
    l_k, g_k = grads32(kernels)
    sync()
    by_design = dict(_build.FLASH_DESIGN_LAUNCHES)
    bwd32 = dict(_build.FLASH_BWD_DESIGN_LAUNCHES)
    check(by_design == {"sm90": 0, "simple": 2 * cfg32.n_layers}
          and bwd32 == {"sm90": 0, "simple": cfg32.n_layers},
          f"f32 train launches by design {by_design}, backward {bwd32}, want all simple")
    l_p, g_p = grads32((plain_fwd, plain_bwd))
    f32_loss_rel = abs(l_k - l_p) / abs(l_p)
    f32_grad_rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(g_k, g_p))
    check(f32_loss_rel <= TRAIN_F32_LOSS_RTOL, f"f32 loss {l_k} vs plain {l_p}")
    check(f32_grad_rel <= TRAIN_F32_GRAD_RTOL,
          f"f32 gradients: largest relative L2 error {f32_grad_rel}")
    log(f"train {cfg32.n_layers} layers f32 B={b32['tokens'].shape[0]} "
        f"S={b32['tokens'].shape[1]}: {by_design['simple']} simple flash "
        f"launches, {bwd32['simple']} simple backward launches; loss {l_k:.7f} vs plain {l_p:.7f} (rel {f32_loss_rel:.3g}); "
        f"largest relative L2 error of a gradient leaf {f32_grad_rel:.3g} "
        f"over {len(g_k)} leaves")
    del m32, g_k, g_p, leaves32

    # a Trainer at SMOKE size killed after a checkpoint and resumed: equal
    # to the unbroken run, bit for bit, with deterministic algorithms on
    smoke = dataclasses.replace(lm_sizes.SMOKE, use_flash_kernel=True)
    n_steps, kill = lm_sizes.CHIP_TRAIN_RESUME_STEPS, lm_sizes.CHIP_TRAIN_RESUME_KILL
    tmp = tempfile.mkdtemp()
    try:
        def trainer(steps, where):
            return Trainer(Model(smoke, device=dev),
                           TokenPipeline(vocab=smoke.vocab, batch=4, seq=64),
                           TrainerConfig(total_steps=steps, ckpt_every=kill,
                                         ckpt_dir=os.path.join(tmp, where),
                                         log_every=1,
                                         train=TrainConfig(opt=opt)))

        # torch refuses cuBLAS under deterministic algorithms unless this
        # names a fixed workspace; 8 buffers of 4 MiB is already the H100's
        # default, so nothing else changes
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        try:
            p_full, _, log_full = trainer(n_steps, "full").run(resume=False)
            trainer(kill, "killed").run(resume=False)
            p_res, _, log_res = trainer(n_steps, "killed").run(resume=True)
        finally:
            torch.use_deterministic_algorithms(False)
        sync()
        same = all(torch.equal(a, b) for a, b in zip(leaves(p_full), leaves(p_res)))
        worst = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(leaves(p_full), leaves(p_res)))
        check([m["loss"] for m in log_res] == [m["loss"] for m in log_full[kill:]],
              "resumed losses differ from the unbroken run's")
        check(same, f"resumed params differ from the unbroken run's (largest "
                    f"relative difference {worst})")
        log(f"train {smoke.name} Trainer, {n_steps} steps killed after the "
            f"checkpoint at {kill} and resumed: params bit-equal to the "
            f"unbroken run (deterministic algorithms on)")
        # the CLI on the card, as a user runs it (started while the kernels'
        # checks ran: train_cli waits for it)
        r = train_cli()
        check(r.returncode == 0 and "[trainer] step 0 loss" in r.stdout,
              f"train CLI rc {r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
        log(f"train CLI --smoke --steps 3 --device {dev.type}: "
            + " | ".join(ln for ln in r.stdout.splitlines() if ln.startswith("[")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # timing: ms per step (median of 3 after a warm-up), peak memory
    with torch.no_grad():
        for p, w in zip(leaves(params), init):
            p.copy_(w)
    del init
    step = make_train_step(model, TrainConfig(opt=opt))
    state = init_opt_state(params)
    batches = [batch_of(pipe, i) for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for i, b in enumerate(batches):
        t1 = time.perf_counter()
        _, state, m = step(params, state, b)
        float(m["loss"])
        sync()
        walls.append(1e3 * (time.perf_counter() - t1))
    ms = statistics.median(walls[1:])
    peak = torch.cuda.max_memory_allocated() - base_mem

    # one profiled step: where the device's time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, state, m = step(params, state, batches[0])
        float(m["loss"])
        sync()
        wall = 1e3 * (time.perf_counter() - t1)
    # the program's spans (repro_torch.trace) also appear on the device's
    # timeline (as annotations spanning their kernels): kernels only here
    by_name = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0 \
                and not e.is_user_annotation:
            by_name[e.key] = e.self_device_time_total / 1e3

    def kernels_under(ev):
        yield from ev.kernels
        for ch in ev.cpu_children:
            yield from kernels_under(ch)

    def range_ms(name, pick=lambda k: True):
        return sum(k.duration for e in prof.events() if e.name == name
                   for k in kernels_under(e) if pick(k.name)) / 1e3

    is_gemm = lambda n: bool(GEMM_KERNEL.search(n)) and "flash" not in n
    shares = {}
    if by_name:
        busy = sum(by_name.values())
        shares = dict(
            busy_ms=busy, wall_ms=wall,
            flash_fwd_ms=sum(v for k, v in by_name.items() if "flash_fwd" in k),
            flash_bwd_ms=sum(v for k, v in by_name.items() if "flash_bwd" in k),
            gemm_ms=sum(v for k, v in by_name.items() if is_gemm(k)),
            adamw_ms=range_ms("adamw_update"))
        # the kernels at the step's shape (BH=60, S=4096, D=64) against the
        # bounds of their operations at the bf16 peak
        qbh, hd = B * cfg.n_heads, cfg.hd
        shares.update(flash_launch_ms=shares["flash_fwd_ms"] / n_flash,
                      flash_bound_ms=1e3 * 4 * hd * qbh * S * (S + 1) / 2
                      / BF16_FLOP_PER_S,
                      flash_bwd_launch_ms=shares["flash_bwd_ms"] / n_bwd,
                      flash_bwd_bound_ms=1e3 * 10 * hd * qbh * S * (S + 1) / 2
                      / BF16_FLOP_PER_S)
        log(f"profile train step, profiler on: wall {wall:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall:.1f}%); flash_attention_fwd "
            f"{shares['flash_fwd_ms']:.3f} ms ({100 * shares['flash_fwd_ms'] / busy:.1f}%), "
            f"flash_attention_bwd {shares['flash_bwd_ms']:.3f} ms "
            f"({100 * shares['flash_bwd_ms'] / busy:.1f}%), GEMMs "
            f"{shares['gemm_ms']:.3f} ms ({100 * shares['gemm_ms'] / busy:.1f}%), "
            f"AdamW {shares['adamw_ms']:.3f} ms; flash_attention_fwd "
            f"{shares['flash_launch_ms']:.4f} ms a launch at BH={qbh}, S={S} "
            f"against a bound of {shares['flash_bound_ms']:.4f} ms; "
            f"flash_attention_bwd {shares['flash_bwd_launch_ms']:.4f} ms a launch "
            f"against {shares['flash_bwd_bound_ms']:.4f} ms")
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:14]:
            log(f"  {t:.3f} ms  {name[:100]}")
    else:
        log("profile train step: the profiler recorded no device time (not measured)")
    # the kernel alone at the step's shape (the folded q, k, v of one
    # layer): held against its plain version on the same inputs, then timed
    # beside it and SDPA with CUDA events
    gen = torch.Generator(device=dev).manual_seed(2)
    fq, fk, fv = (torch.randn((B * cfg.n_heads, S, cfg.hd), generator=gen,
                              device=dev, dtype=torch.bfloat16) for _ in range(3))
    blk = 128  # gqa_attention's blocks

    def kernel_at_s():
        return kops.flash_attention_fwd(fq, fk, fv, causal=True, block_q=blk,
                                        block_k=blk, schedule=cfg.flash_schedule)

    def plain_at_s():
        return ref.flash_attention_ref(fq, fk, fv, causal=True)

    _build.reset_launches()
    got_at_s = kernel_at_s()
    sync()
    check(dict(_build.FLASH_DESIGN_LAUNCHES) == {"sm90": 1, "simple": 0},
          f"flash at the train step's shape ran {dict(_build.FLASH_DESIGN_LAUNCHES)}")
    err_at_s = flash_err(got_at_s, plain_at_s(),
                         f"{tuple(fq.shape)} bf16 causal, the train step's shape")
    del got_at_s
    flash_at_s = dict(
        max_abs_err=err_at_s,
        kernel_ms=events_ms(kernel_at_s),
        plain_ms=events_ms(plain_at_s, reps=3, inner=1),
        library_ms=events_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            *(t.view(B, cfg.n_heads, S, cfg.hd) for t in (fq, fk, fv)),
            is_causal=True)),
        bound_ms=1e3 * 4 * cfg.hd * B * cfg.n_heads * S * (S + 1) / 2
        / BF16_FLOP_PER_S)
    del fq, fk, fv
    log(f"flash_attention_fwd at the train step's shape ({B * cfg.n_heads}, "
        f"{S}, {cfg.hd}) bf16 causal, Hopper design: max |d| against the "
        f"plain version {err_at_s:.3g}; {flash_at_s['kernel_ms']:.4f} ms; plain {flash_at_s['plain_ms']:.3f} ms; "
        f"SDPA {flash_at_s['library_ms']:.4f} ms; bound "
        f"{flash_at_s['bound_ms']:.4f} ms by operations")
    log(f"train {cfg.name} B={B} S={S}: {ms:.3f} ms per step (median of 3 "
        f"after a warm-up; {', '.join(f'{w:.1f}' for w in walls)} ms), "
        f"{B * S / ms * 1e3:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
        f"above the {base_mem / 2**30:.2f} GiB held before the phase "
        f"({time.perf_counter() - t0:.1f} s)")
    bwd = bwd_checks(dev, flash_err)
    return dict(launches=counts["flash_attention_fwd"],
                bwd_launches=counts["flash_attention_bwd"], bwd=bwd, training=dict(
        launches_per_step=n_flash, by_design={"sm90": n_flash, "simple": 0},
        bwd_launches_per_step=n_bwd, bwd_by_design={"sm90": n_bwd, "simple": 0},
        ref_attention_calls=plain_calls,
        batch=B, seq=S, ms_per_step=ms, tokens_per_s=B * S / ms * 1e3,
        peak_bytes=peak, loss=got["loss"], grad_norm=got["grad_norm"],
        repeat_bit_equal=repeat, plain_loss_rel=loss_rel, plain_gnorm_rel=gn_rel,
        microbatch2_loss_rel=micro_rel, f32_loss_rel=f32_loss_rel,
        f32_grad_rel_l2=f32_grad_rel, resume_bit_equal=same,
        flash_at_train_shape=flash_at_s, profile=shares))


def bwd_checks(dev, flash_err) -> dict:
    """``flash_attention_bwd`` alone, on inputs from a seeded generator and
    the forward kernel's o and lse: the Hopper design at
    ``BWD_SM90_SHAPES`` (bf16, causal, 128-blocks) and the simple design at
    ``BWD_SIMPLE_CASES`` (causal, 128-blocks, 64 at D=1152), each launch's
    design, forward and backward, asserted, o held against the plain
    forward (``flash_err``) and dq, dk, dv against the plain backward on
    the same inputs (relative L2 error, ``BWD_*``); each timed with CUDA
    events beside its plain version, ``aten._scaled_dot_product_flash_attention_
    backward`` where it takes the dtype and head dim (a yardstick the port
    never calls) and the bound of its operations (10·D per visible (q row,
    key) pair) or bytes, whichever is larger. Returns the readings for the
    ``flash_attention_bwd`` row: the top-level numbers are the Hopper
    design's at the training step's shape."""
    import torch

    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attn import (flash_attention_bwd,
                                                flash_attention_fwd, flash_design)

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(3)
    peak = {torch.float32: F32_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S,
            torch.float16: F16_FLOP_PER_S, torch.float8_e4m3fn: FP8_FLOP_PER_S}

    def one(dtype, BH, S, D, blk, want_design, tol):
        q, k, v, do = (ref.round_to(torch.randn((BH, S, D), generator=gen, device=dev),
                                    dtype) for _ in range(4))
        check(flash_design(dtype, D, blk, blk) == want_design,
              f"flash_attention_bwd {dtype} D={D}: design {flash_design(dtype, D, blk, blk)}")
        _build.reset_launches()
        o, lse = flash_attention_fwd(q, k, v, causal=True, block_q=blk, block_k=blk,
                                     return_lse=True)
        kw = dict(causal=True, block_q=blk, block_k=blk)
        kernel = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = lambda: ref.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
        got = kernel()
        sync()
        one_launch = {"sm90": 0, "simple": 0, want_design: 1}
        check(dict(_build.FLASH_DESIGN_LAUNCHES) == one_launch
              and dict(_build.FLASH_BWD_DESIGN_LAUNCHES) == one_launch,
              f"flash {dtype} {(BH, S, D)} ran forward "
              f"{dict(_build.FLASH_DESIGN_LAUNCHES)}, backward "
              f"{dict(_build.FLASH_BWD_DESIGN_LAUNCHES)}, want {want_design}")
        fwd_err = flash_err(o, ref.flash_attention_ref(q, k, v, causal=True),
                            f"{(BH, S, D)} {dtype} causal {blk}-blocks, before the backward")
        want = plain()
        rel = [((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(got, want)]
        err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, want))
        what = f"flash_attention_bwd {want_design} {dtype} (BH, S, D) = {(BH, S, D)}"
        check(all(a.dtype == dtype and a.shape == b.shape
                  and bool(torch.isfinite(a.float()).all()) for a, b in zip(got, want))
              and max(rel) <= tol,
              f"{what}: relative L2 errors of dq, dk, dv {rel} (tolerance {tol})")
        del got, want
        ops = 10 * D * BH * S * (S + 1) // 2
        nbytes = (8 * q.numel()) * q.element_size() + 4 * lse.numel()
        b_ops, b_bytes = 1e3 * ops / peak[dtype], 1e3 * nbytes / HBM_BYTES_PER_S
        big = BH * S * S > 5e8
        r = dict(shape=[BH, S, D], dtype=str(dtype).split(".")[-1], design=want_design,
                 fwd_max_abs_err=fwd_err, rel_l2=dict(zip(("dq", "dk", "dv"), rel)),
                 max_abs_err=err,
                 ms=events_ms(kernel, reps=3 if big else 5, inner=1 if big else 5),
                 plain_ms=events_ms(plain, reps=3, inner=1),
                 bound_ms=max(b_ops, b_bytes),
                 bound_by="operations" if b_ops >= b_bytes else "bytes",
                 library_ms=None)
        if dtype in (torch.bfloat16, torch.float16) and D <= 256:
            q4, k4, v4, do4 = (t.view(1, BH, S, D) for t in (q, k, v, do))
            fwd = torch.ops.aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, True, False)
            o4, lse4, cq, ck, mq, mk, seed, offset = fwd[:8]
            r["library_ms"] = events_ms(
                lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, o4, lse4, cq, ck, mq, mk, 0.0, True, seed, offset))
            del fwd, o4, lse4
        log(f"{what} causal, blocks {blk}: o max |d| {fwd_err:.3g}; relative L2 "
            f"errors of dq, dk, dv against the plain version "
            f"{', '.join(f'{e:.3g}' for e in rel)} (max |d| {err:.3g}); {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
            + (f"library flash backward {r['library_ms']:.4f} ms, "
               if r["library_ms"] is not None else "")
            + f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} ({ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; {100 * r['bound_ms'] / r['ms']:.1f}% of it reached)")
        return r

    sm90 = [one(torch.bfloat16, BH, S, D, 128, "sm90", BWD_SM90_REL_L2)
            for BH, S, D in BWD_SM90_SHAPES]
    simple = [one(getattr(torch, dt), BH, S, D, 64 if D > 1024 else 128, "simple",
                  BWD_F32_REL_L2 if dt == "float32" else torch.finfo(getattr(torch, dt)).eps)
              for dt, BH, S, D in BWD_SIMPLE_CASES]
    top = sm90[0]
    log(f"flash_attention_bwd alone: {len(sm90)} Hopper and {len(simple)} simple "
        f"cases ({time.perf_counter() - t0:.1f} s)")
    return dict(max_abs_err=top["max_abs_err"], ms=top["ms"], plain_ms=top["plain_ms"],
                bound_ms=top["bound_ms"], bound_by=top["bound_by"],
                library_ms=top["library_ms"], sm90=sm90, simple=simple)


# one rank of two sharing card 0: a process group of ``backend``, then a
# DTensor redistribute (an all-gather) of a CUDA tensor over both ranks
SHARED_CARD_RANK = """
import sys, torch, torch.distributed as dist
from datetime import timedelta
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
backend, rank, init = sys.argv[1], int(sys.argv[2]), sys.argv[3]
torch.cuda.set_device(0)
kw = {"device_id": torch.device("cuda", 0)} if backend == "nccl" else {}
dist.init_process_group(backend, init_method="file://" + init, world_size=2,
                        rank=rank, timeout=timedelta(seconds=60), **kw)
mesh = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
x = distribute_tensor(torch.arange(8.0, device="cuda"), mesh, [Shard(0)])
assert torch.equal(x.redistribute(placements=[Replicate()]).to_local(),
                   torch.arange(8.0, device="cuda"))
dist.destroy_process_group()
print("SHARED_CARD_OK")
"""


def shared_card_backends() -> dict:
    """For nccl and gloo: two ranks on card 0 run a DTensor all-gather of a
    CUDA tensor (``SHARED_CARD_RANK``); each backend's exit codes and the
    last line either rank wrote. A reading, checked by nothing: it records
    why the elastic CLI's ranks do not share the card."""
    out = {}
    for backend in ("nccl", "gloo"):
        work = tempfile.mkdtemp()
        try:
            procs = [subprocess.Popen(
                [sys.executable, "-c", SHARED_CARD_RANK, backend, str(r),
                 os.path.join(work, "rendezvous")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True) for r in range(2)]
            codes, last = [], ""
            for p in procs:
                try:
                    text, _ = p.communicate(timeout=120)
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                codes.append(p.returncode)
                lines = [ln for ln in text.splitlines()
                         if ln.strip() and "Warning" not in ln and "warn" not in ln]
                last = last or next((ln for ln in reversed(lines)
                                     if "Error" in ln or "Fatal" in ln
                                     or "SHARED_CARD_OK" in ln), "")
            out[backend] = {"exit_codes": codes, "last_line": last[-300:]}
        finally:
            shutil.rmtree(work, ignore_errors=True)
    return out


# the dry run's cells on the card, cut from train_4k, prefill_32k and
# decode_32k to one card's batch: (seq, batch, mode)
DRYRUN_CELLS = {"chip_train": (4096, 4, "train"), "chip_prefill": (2048, 4, "prefill"),
                "chip_decode": (2048, 4, "decode")}
# what the count on meta must equal on the card, as integers
DRYRUN_KEYS = ("flops_per_dev", "flops_by_kind", "bytes_per_dev", "coll_bytes")

# the dry run on the meta device in a process that uses no CUDA: the
# DRYRUN_CELLS of full-width smollm-360m on a (1, 1) mesh of torch's fake
# process group of one rank while, in a process of its own, the production
# CLI (train_4k on the single-pod mesh, 256 fake ranks) writes into argv[2]
DRYRUN_META = """
import json, subprocess, sys, threading, time
cells, out_dir = json.loads(sys.argv[1]), sys.argv[2]
cli_t0, cli_out = time.perf_counter(), {}
cli = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "smollm-360m", "--shape", "train_4k", "--mesh",
                        "single", "--out", out_dir], stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
def wait_cli():
    cli_out["text"] = cli.communicate(timeout=600)[0]
    cli_out["s"] = time.perf_counter() - cli_t0
waiter = threading.Thread(target=wait_cli)
waiter.start()
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import dryrun
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
got = {}
for name, (S, B, mode) in cells.items():
    t0 = time.perf_counter()
    rec = dryrun.run_cell("smollm-360m", ShapeSpec(name, S, B, mode), mesh,
                          "meta_1x1", dict(dryrun.DEFAULT_OPTS))
    got[name] = {**{k: rec[k] for k in ("flops_per_dev", "flops_by_kind",
                                        "bytes_per_dev", "coll_bytes",
                                        "memory_per_device", "t_compute_s",
                                        "t_memory_s", "t_collective_s",
                                        "t_bound_s")},
                 "seconds": time.perf_counter() - t0}
dist.destroy_process_group()
waiter.join()
assert cli.returncode == 0, cli_out["text"][-3000:]
assert not torch.cuda.is_initialized(), "the meta dry run touched CUDA"
roofline = [ln.strip() for ln in cli_out["text"].splitlines()
            if ln.strip().startswith("roofline:")]
print("DRYRUN_META " + json.dumps({"cells": got, "cli_s": cli_out["s"],
                                   "cli_roofline": roofline[-1]}), flush=True)
"""


def start_dryrun_meta(work: str) -> subprocess.Popen:
    """Start ``DRYRUN_META`` in a process that sees no card
    (``CUDA_VISIBLE_DEVICES`` empty), its output into files under
    ``work``: it needs nothing built and no card, so it runs while nvcc
    builds the kernels, and ``dryrun_check`` reads it."""
    with open(os.path.join(work, "dryrun_meta.out"), "w") as out, \
            open(os.path.join(work, "dryrun_meta.err"), "w") as err:
        child = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_META, json.dumps(DRYRUN_CELLS),
             os.path.join(work, "dryrun_cli")],
            stdout=out, stderr=err, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": "",
                 "PYTHONPATH": str(ROOT / "src")})
        with contextlib.suppress(OSError):
            os.setpriority(os.PRIO_PROCESS, child.pid, CHILD_NICE)
        return child


def dryrun_check(dev, mesh, child: subprocess.Popen, work: str) -> dict:
    """The dry run (``repro_torch.launch.dryrun.run_cell``) on the card, on
    the one-rank nccl ``mesh`` (1, 1), against the same count on meta.

    Full-width smollm-360m, ``DEFAULT_OPTS`` (flash=0): each cell of
    ``DRYRUN_CELLS`` counted on the card, then run once more outside the
    count (ms, and the allocator's peak over the step against the count's
    predicted peak); the child process ``child`` (``start_dryrun_meta``,
    its output under ``work``), which uses no CUDA, counts the same
    cells on meta under a one-rank fake group, whose flops, flops by kind,
    bytes, collective bytes and argument bytes must equal the card's as
    integers, then runs the production CLI (train_4k, the single-pod mesh
    under 256 fake ranks). Last the prefill at flash=1 on the card, counted
    as a main path: 32 ``flash_attention_fwd`` launches charged by the
    count, and 64 by the per-design counter, all sm90 (``run_cell`` runs
    the step once before the one it counts)."""
    import torch

    from repro_torch.configs.registry import ShapeSpec
    from repro_torch.kernels import _build
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    try:
        card = {}
        for name, (S, B, mode) in DRYRUN_CELLS.items():
            t1 = time.perf_counter()
            rec = dryrun.run_cell("smollm-360m", ShapeSpec(name, S, B, mode), mesh,
                                  "card_1x1", dict(dryrun.DEFAULT_OPTS), device=dev,
                                  measure=True)
            rec["seconds"] = time.perf_counter() - t1
            card[name] = rec
            torch.cuda.empty_cache()
        _build.reset_launches()
        flash = dryrun.run_cell("smollm-360m", ShapeSpec("chip_prefill", 2048, 4, "prefill"),
                                mesh, "card_1x1", {**dryrun.DEFAULT_OPTS, "flash": 1},
                                device=dev)
        counts, by_design = dict(_build.LAUNCHES), dict(_build.FLASH_DESIGN_LAUNCHES)
        n_flash = 32  # one a layer; run_cell runs the step twice, counting the second
        charged = flash["kernels"].get("flash_attention_fwd", {}).get("launches")
        check(charged == n_flash, f"dry run flash=1: {charged} charged flash launches, "
              f"want {n_flash}")
        check(counts == {**{k: 0 for k in counts}, "flash_attention_fwd": 2 * n_flash}
              and by_design == {"sm90": 2 * n_flash, "simple": 0},
              f"dry run flash=1 launches {counts}, by design {by_design}, want "
              f"{2 * n_flash} sm90 (the steady-state step and the one before it)")
        torch.cuda.empty_cache()
        try:
            child.wait(timeout=max(300 - (time.perf_counter() - t0), 30))
        except subprocess.TimeoutExpired:
            pass
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    with open(os.path.join(work, "dryrun_meta.out")) as f_out, \
            open(os.path.join(work, "dryrun_meta.err")) as f_err:
        text, err = f_out.read(), f_err.read()
    line = next((ln for ln in text.splitlines() if ln.startswith("DRYRUN_META ")), None)
    check(child.returncode == 0 and line is not None,
          f"the meta dry run failed (exit {child.returncode}): {err[-3000:]}")
    meta = json.loads(line[len("DRYRUN_META "):])
    cli_line = meta["cli_roofline"]
    out = {}
    for name, rec in card.items():
        m = meta["cells"][name]
        for k in DRYRUN_KEYS:
            check(rec[k] == m[k], f"dry run {name}: {k} on the card {rec[k]} != "
                  f"on meta {m[k]}")
        arg, marg = (rec["memory_per_device"]["argument_bytes"],
                     m["memory_per_device"]["argument_bytes"])
        check(arg == marg, f"dry run {name}: argument bytes on the card {arg} != "
              f"on meta {marg}")
        ms, bound_ms = rec["measured"]["ms"], 1e3 * rec["t_bound_s"]
        peak, want_peak = (rec["measured"]["peak_bytes"],
                           rec["memory_per_device"]["peak_bytes"])
        log(f"dry run {name} (smollm-360m S={DRYRUN_CELLS[name][0]} "
            f"B={DRYRUN_CELLS[name][1]}, card (1, 1) mesh): flops {rec['flops_per_dev']} "
            f"({rec['flops_by_kind']}), bytes {rec['bytes_per_dev']}, collective "
            f"{sum(rec['coll_bytes'].values())}: equal to the meta count; roofline "
            f"compute {1e3 * rec['t_compute_s']:.3f} ms, memory "
            f"{1e3 * rec['t_memory_s']:.3f} ms, collective "
            f"{1e3 * rec['t_collective_s']:.3f} ms -> bound {bound_ms:.3f} ms "
            f"({rec['bottleneck']}); measured {ms:.3f} ms ({ms / bound_ms:.2f}x the "
            f"bound); peak {peak / 2**30:.3f} GiB against the predicted "
            f"{want_peak / 2**30:.3f} GiB ({peak / want_peak:.3f}x); counted in "
            f"{rec['t_count_s']:.1f} s, on meta in {m['seconds']:.1f} s")
        out[name] = dict(
            seq=DRYRUN_CELLS[name][0], batch=DRYRUN_CELLS[name][1],
            flops=rec["flops_per_dev"], flops_by_kind=rec["flops_by_kind"],
            matmul_flops_by_dtype=rec["matmul_flops_by_dtype"],
            bytes=rec["bytes_per_dev"], coll_bytes=rec["coll_bytes"],
            t_compute_ms=1e3 * rec["t_compute_s"], t_memory_ms=1e3 * rec["t_memory_s"],
            t_collective_ms=1e3 * rec["t_collective_s"], bound_ms=bound_ms,
            bottleneck=rec["bottleneck"], measured_ms=ms, measured_over_bound=ms / bound_ms,
            peak_bytes=peak, predicted_peak_bytes=want_peak,
            memory=rec["memory_per_device"], torch_raw=rec["torch_raw"],
            count_s=rec["t_count_s"], meta_s=m["seconds"], meta_equal=True)
    log(f"dry run prefill flash=1 on the card: {charged} flash_attention_fwd launches "
        f"charged ({flash['kernels']['flash_attention_fwd']['bytes']} bytes), all sm90; "
        f"bytes {flash['bytes_per_dev']}, roofline bound {1e3 * flash['t_bound_s']:.3f} ms")
    log(f"dry run CLI on meta (smollm-360m train_4k, single pod, 256 fake ranks): "
        f"{cli_line} ({meta['cli_s']:.1f} s); the phase {time.perf_counter() - t0:.1f} s")
    return dict(launches=2 * n_flash, cells=out, flash_prefill=dict(
        launches=charged, charged_bytes=flash["kernels"]["flash_attention_fwd"]["bytes"],
        bytes=flash["bytes_per_dev"], bound_ms=1e3 * flash["t_bound_s"]),
        cli_roofline=cli_line, cli_s=meta["cli_s"],
        seconds=time.perf_counter() - t0)


def mesh_phase(dev, unsharded: dict, background: dict) -> dict:
    """The training path over a torch device mesh: ``smollm-360m`` at full
    width (32 layers, bf16 activations, f32 master weights,
    ``use_flash_kernel``, ``remat=True``) at ``CHIP_TRAIN_*`` on a
    one-rank nccl ``DeviceMesh`` (1, 1) ("data", "model"): every parameter,
    ``m`` and ``v`` a DTensor placed by ``partition_specs`` ->
    ``sanitize_specs``, the residual pinned by ``act_spec=(batch_axes,
    "model", None)`` (the dry run's ``act_seq_shard``). Three steps held
    against the unsharded ``make_train_step`` on the same weights and
    batches (``train_phase``'s bf16 gates), 64 ``sm90`` flash launches and
    32 ``sm90`` backward launches a step (counted: a main path), the
    sharded tree checkpointed and
    restored with ``shardings=`` onto the mesh bit for bit; then ms per
    step, peak memory and one profiled step's busy share beside
    ``unsharded`` (``train_phase``'s readings). Ranks sharing one card:
    nccl refuses a second rank on the device, and gloo, which carries
    plain collectives of CUDA tensors, crashes in DTensor's functional
    collectives, so the elastic CLI's 8 ranks are not run here (that
    reading, ``shared_card_backends``, was started beside the kernels'
    checks, and the dry run's meta count while the kernels built:
    ``background["shared"]`` waits for the first,
    ``background["dryrun_meta"]`` is the second's process, writing under
    ``background["work"]``)."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import smollm_360m as lm_sizes
    from repro_torch.data import TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.dryrun import sanitize_specs
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import Model
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                   make_train_step)

    t0 = time.perf_counter()
    sync = torch.cuda.synchronize
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0,
                            device_id=torch.device("cuda", torch.cuda.current_device()))
    tmp = tempfile.mkdtemp()
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(lm_sizes.CONFIG, use_flash_kernel=True)
        scfg = dataclasses.replace(cfg, act_spec=(batch_axes(mesh), "model", None))
        B, S = lm_sizes.CHIP_TRAIN_BATCH, lm_sizes.CHIP_TRAIN_SEQ
        n_flash, n_bwd = 2 * cfg.n_layers, cfg.n_layers
        opt = OptConfig(warmup_steps=1, total_steps=10)
        pipe = TokenPipeline(vocab=cfg.vocab, batch=B, seq=S, seed=0)
        batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
                   for i in range(MESH_STEPS)]
        base_mem = torch.cuda.memory_allocated()
        model = Model(scfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0)).requires_grad_()
        init = [p.detach().clone() for p in leaves(model.params())]
        model.shard(mesh, sanitize_specs(mesh, model.specs(), model.defs()))
        params = model.params()
        state = init_opt_state(params)
        check(all(isinstance(x, DTensor) for x in leaves(params) + leaves(state["m"])
                  + leaves(state["v"])), "mesh: a parameter or AdamW leaf is not a DTensor")
        check(all(m.placements == p.placements for m, p in
                  zip(leaves(state["m"]), leaves(params))),
              "mesh: AdamW's m does not live with its parameter")
        step = make_train_step(model, TrainConfig(opt=opt))
        got, walls = [], []
        for b in batches:
            _build.reset_launches()
            sync()
            t1 = time.perf_counter()
            params, state, m = step(params, state, b)
            got.append({k: float(v) for k, v in m.items()})
            sync()
            walls.append(1e3 * (time.perf_counter() - t1))
            counts = dict(_build.LAUNCHES)
            by_design = dict(_build.FLASH_DESIGN_LAUNCHES)
            bwd_by_design = dict(_build.FLASH_BWD_DESIGN_LAUNCHES)
            check(counts == {**{n: 0 for n in counts}, "flash_attention_fwd": n_flash,
                             "flash_attention_bwd": n_bwd},
                  f"mesh step launches {counts}, want {n_flash} flash_attention_fwd "
                  f"and {n_bwd} flash_attention_bwd")
            check(by_design == {"sm90": n_flash, "simple": 0}
                  and bwd_by_design == {"sm90": n_bwd, "simple": 0},
                  f"mesh step flash launches by design {by_design}, backward "
                  f"{bwd_by_design}")
        launches, bwd_launches = n_flash * len(batches), n_bwd * len(batches)

        # the unsharded step on the same weights and batches
        plain_model = Model(cfg, device=dev).requires_grad_()
        with torch.no_grad():
            for p, w in zip(leaves(plain_model.params()), init):
                p.copy_(w)
        del init
        pparams = plain_model.params()
        pstate = init_opt_state(pparams)
        pstep = make_train_step(plain_model, TrainConfig(opt=opt))
        want = []
        for b in batches:
            pparams, pstate, m = pstep(pparams, pstate, b)
            want.append({k: float(v) for k, v in m.items()})
        loss_rel = max(abs(g["loss"] - w["loss"]) / abs(w["loss"]) for g, w in zip(got, want))
        gn_rel = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                     for g, w in zip(got, want))
        metrics_equal = got == want
        params_equal = all(torch.equal(a.to_local(), b)
                           for a, b in zip(leaves(params), leaves(pparams)))
        check(loss_rel <= TRAIN_BF16_LOSS_RTOL, f"mesh losses {got} vs unsharded {want}")
        check(gn_rel <= TRAIN_BF16_GNORM_RTOL, f"mesh grad norms {got} vs unsharded {want}")
        del plain_model, pparams, pstate, pstep
        torch.cuda.empty_cache()
        log(f"mesh {cfg.name} B={B} S={S} on a (1, 1) nccl mesh, {MESH_STEPS} steps: "
            f"{n_flash} sm90 flash launches and {n_bwd} sm90 backward launches a "
            f"step; losses "
            f"{[round(g['loss'], 6) for g in got]}, grad norms "
            f"{[round(g['grad_norm'], 6) for g in got]}; against the unsharded "
            f"step: loss rel {loss_rel:.3g}, grad norm rel {gn_rel:.3g}, metrics "
            f"bit-equal {metrics_equal}, params bit-equal {params_equal}")

        # the sharded tree checkpointed, restored onto the mesh with shardings=
        tree = {"params": params, "opt_state": state}
        t1 = time.perf_counter()
        ckpt.save(tmp, MESH_STEPS, tree, meta={"step": MESH_STEPS})
        save_s = time.perf_counter() - t1
        sh = tree_map(lambda x: (mesh, x.placements), params)
        t1 = time.perf_counter()
        back, meta = ckpt.restore(tmp, device=dev, shardings={
            "params": sh, "opt_state": {"m": sh, "v": sh}})
        restore_s = time.perf_counter() - t1
        pairs = list(zip(leaves(tree["params"]) + leaves(state["m"]) + leaves(state["v"]),
                         leaves(back["params"]) + leaves(back["opt_state"]["m"])
                         + leaves(back["opt_state"]["v"])))
        restored = all(isinstance(b, DTensor) and a.placements == b.placements
                       and torch.equal(a.to_local(), b.to_local()) for a, b in pairs)
        check(restored and meta == {"step": MESH_STEPS}
              and int(back["opt_state"]["step"]) == int(state["step"]),
              "mesh: the restored sharded checkpoint differs")
        nbytes = sum(a.to_local().numel() * a.to_local().element_size() for a, _ in pairs)
        del back, pairs
        log(f"mesh checkpoint of params, m and v ({nbytes / 2**30:.2f} GiB) "
            f"saved in {save_s:.2f} s, restored with shardings= in {restore_s:.2f} s: "
            f"bit-equal, placements kept")

        # timing: ms per step (median of 3 after the checked steps), peak
        torch.cuda.reset_peak_memory_stats()
        times = []
        for b in batches:
            sync()
            t1 = time.perf_counter()
            params, state, m = step(params, state, b)
            float(m["loss"])
            sync()
            times.append(1e3 * (time.perf_counter() - t1))
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() - base_mem
        # device activity only: a trace of the host's ops too takes the
        # profiler longer to aggregate than the step takes to run
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            params, state, m = step(params, state, batches[0])
            float(m["loss"])
            sync()
            wall = 1e3 * (time.perf_counter() - t1)
        by_name = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")
                   and not e.is_user_annotation}
        busy = sum(by_name.values())
        busy_share = busy / wall if busy else None
        flash_ms = sum(v for k, v in by_name.items() if "flash_fwd" in k) / n_flash
        bwd_ms = sum(v for k, v in by_name.items() if "flash_bwd" in k) / n_bwd
        log(f"mesh step {ms:.3f} ms (median of {len(times)}: "
            f"{', '.join(f'{w:.1f}' for w in times)}; the checked steps "
            f"{', '.join(f'{w:.1f}' for w in walls)}) against the unsharded "
            f"{unsharded['ms_per_step']:.3f} ms ({ms / unsharded['ms_per_step']:.3f}x); "
            f"peak {peak / 2**30:.2f} GiB against {unsharded['peak_bytes'] / 2**30:.2f}; "
            + (f"profiled step: wall {wall:.3f} ms, device busy {busy:.3f} ms "
               f"({100 * busy_share:.1f}%), flash_attention_fwd {flash_ms:.4f} ms "
               f"a launch, flash_attention_bwd {bwd_ms:.4f} ms a launch" if busy else
               "profiled step: no device time recorded (not measured)")
            + f" ({time.perf_counter() - t0:.1f} s)")
        # the dry run on the card, with the mesh up (the phase's own
        # model, its state and their gradients freed first)
        del model, params, state, tree, sh, step, m
        torch.cuda.empty_cache()
        dry = dryrun_check(dev, mesh, background["dryrun_meta"], background["work"])
        launches += dry["launches"]
        shared = background["shared"]()
        log(f"mesh: two ranks sharing the card, a DTensor all-gather: "
            + "; ".join(f"{b} exit {r['exit_codes']} ({r['last_line'][:160]})"
                        for b, r in shared.items())
            + f" ({time.perf_counter() - t0:.1f} s)")
        return dict(launches=launches, bwd_launches=bwd_launches, mesh=dict(
            mesh=[1, 1], backend="nccl", batch=B, seq=S, steps=MESH_STEPS,
            launches_per_step=n_flash, bwd_launches_per_step=n_bwd,
            losses=[g["loss"] for g in got],
            grad_norms=[g["grad_norm"] for g in got], loss_rel=loss_rel,
            gnorm_rel=gn_rel, metrics_bit_equal=metrics_equal,
            params_bit_equal=params_equal, ckpt_bytes=nbytes, ckpt_save_s=save_s,
            ckpt_restore_s=restore_s, ms_per_step=ms, unsharded_ms_per_step=
            unsharded["ms_per_step"], peak_bytes=peak, busy_ms=busy or None,
            wall_ms=wall, busy_share=busy_share,
            flash_launch_ms=flash_ms if busy else None,
            flash_bwd_launch_ms=bwd_ms if busy else None,
            seconds=time.perf_counter() - t0,
            shared_card=shared), dryrun=dry)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()


def archs_phase(dev, flash_err) -> dict:
    """The other LMs at full width, one at a time (each one's
    tensors freed before the next): the config modules of
    ``ARCH_MODULES`` at the depth ``CHIP_LAYERS`` of each, bf16
    activations, f32 weights from a seeded ``torch.Generator`` and
    ``use_flash_kernel``. Each: a counted ``Model.prefill`` at B=4, S=2048
    (one ``sm90`` flash launch a layer where the attention is GQA without
    a window; none for gemma3-1b's windows and MLA), ``greedy_decode`` of
    4 requests (no launch), decode's logits against the prefill's in f32
    activations (bf16 reported), prefill and decode timed, the peak memory
    and one profiled prefill. Where flash runs, the kernel alone at that
    prefill's folded shape against its plain version (``flash_err``),
    timed beside it, SDPA and its bound, and where ``CHIP_F32_LAYERS`` is
    set, that many layers in f32 activations with the kernel against the
    same prefill with its plain version. gemma3-1b: 6 layers (five local,
    one global) decoded 520 steps, past the window, against the prefill;
    temperature sampling. The MoE archs: the prefill's share of dropped
    assignments at the config's capacity factor, decode against prefill
    at a capacity factor where none drops, and 2 layers in f32 on the card
    against the CPU stage by stage (end to end reported). Returns the
    readings (``launches``: the counted prefills' flash launches)."""
    import importlib

    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.models import Model
    from repro_torch.models import mamba2 as tmamba
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embed, rmsnorm, unembed
    from repro_torch.models.params import init_params, leaves as tree_leaves, tree_map
    from repro_torch.serve import greedy_decode, make_serve_step
    from repro_torch.serve.serve_step import gumbel_noise

    sync = torch.cuda.synchronize
    t_phase = time.perf_counter()
    base_mem = torch.cuda.memory_allocated()
    log(f"archs phase: {base_mem / 2**30:.2f} GiB held before it")
    kernel_fwd = kops.flash_attention_fwd

    def with_fwd(fwd, fn):
        kops.flash_attention_fwd = fwd
        try:
            with torch.no_grad():
                return fn()
        finally:
            kops.flash_attention_fwd = kernel_fwd

    def counted(fn):
        _build.reset_launches()
        out = fn()
        sync()
        return out, dict(_build.LAUNCHES), dict(_build.FLASH_DESIGN_LAUNCHES)

    def first_layers(params, cfg, n):
        """The parameters of ``cfg``'s first ``n`` layers (views): every
        dense layer of the moe family, then the rest from ``layers``; the
        other trees (a hybrid's ``shared_block``, whose applications the
        cut config recounts, an encoder's ``enc_layers``) whole."""
        k = cfg.moe.first_k_dense if cfg.family == "moe" else 0
        out = {**params, "layers": tree_map(
            lambda t: t[:n - k], params["layers"])}
        return out, dataclasses.replace(cfg, n_layers=n)

    def flash_launches(cfg) -> int:
        """``sm90`` flash launches in one prefill of ``cfg``: one per
        causal GQA attention without a window (the decoder's layers, a
        hybrid's shared-block applications); none for MLA, windows, the
        ssm family, an encoder or a cross-attention."""
        if cfg.family == "ssm" or cfg.mla is not None or cfg.sliding_window is not None:
            return 0
        return tfm._n_shared_apps(cfg) if cfg.family == "hybrid" else cfg.n_layers

    def decode_vs_prefill(params_, c, tokens, frames=None):
        """max |decode's last logits - prefill's| and argmax agreement,
        the cache filled by teacher-forced steps over ``tokens`` (an
        encdec model's cross cache first from the encoder's output on
        ``frames``, which its prefill reads too)."""
        n_b, n_t = tokens.shape
        extra = {} if frames is None else {"frames": frames}
        with torch.no_grad():
            cache = init_params(tfm.cache_defs(c, n_b, n_t), None,
                                torch.float32, dev)
            if frames is not None:
                ek, ev = tfm._enc_kv_all(params_, tfm._encode(params_, frames, c, False), c)
                cache["cross"]["k"].copy_(ek)
                cache["cross"]["v"].copy_(ev)
            for t in range(n_t):
                dec, cache = tfm.decode_step(params_, cache, {
                    "tokens": tokens[:, t:t + 1], "cur": t}, c)
            pre = tfm.prefill(params_, {"tokens": tokens, **extra}, c)
        return ((dec[:, 0] - pre).abs().max().item(),
                int((dec[:, 0].argmax(-1) == pre.argmax(-1)).sum()))

    def serve_arch(sz) -> dict:
        """One arch's runs and checks (its tensors go when it returns)."""
        t0 = time.perf_counter()
        cfg = dataclasses.replace(sz.CONFIG, n_layers=sz.CHIP_LAYERS,
                                  use_flash_kernel=True)
        B, S = sz.CHIP_PREFILL_BATCH, sz.CHIP_PREFILL_SEQ
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        params = model.params()
        r = dict(layers=cfg.n_layers, of_layers=sz.CONFIG.n_layers,
                 n_params=model.n_params(), batch=B, seq=S)
        batch = concrete_batch(cfg, ShapeSpec("chip_prefill", S, B, "prefill"),
                               seed=0, device=dev)
        torch.cuda.reset_peak_memory_stats()
        logits, counts, by_design = counted(lambda: model.prefill(batch))
        n_flash = flash_launches(cfg)
        check(counts == {**{n: 0 for n in counts}, "flash_attention_fwd": n_flash},
              f"{cfg.name} prefill launches {counts}, want {n_flash} flash_attention_fwd")
        check(by_design == {"sm90": n_flash, "simple": 0},
              f"{cfg.name} prefill flash launches by design {by_design}")
        check(logits.shape == (B, cfg.vocab_padded) and bool(torch.isfinite(logits).all()),
              f"{cfg.name} prefill logits not finite or misshapen")
        if cfg.family == "encdec":
            log(f"archs {cfg.name}: the encoder ({cfg.encdec.n_enc_layers} layers, "
                f"bidirectional over {tuple(batch['frames'].shape)} frames) and the "
                f"cross-attention run plain softmax attention, no kernel; the "
                f"{n_flash} flash launches are the decoder's causal self-attention")
        r.update(flash_launches=n_flash, by_design=by_design,
                 logit_std=logits.std().item())

        # decode: 4 requests through greedy_decode, then decode's logits at
        # the last prompt position against the prefill's on the prompts, in
        # bf16 (reported: the two round at other places, and over 26 layers
        # and 262,144 logits gemma3-1b's sat 0.104 apart, past smollm's
        # LM_LOGIT_TOL) and in f32 activations (held to LM_F32_LOGIT_TOL:
        # the same arithmetic summed in other orders). A MoE prefill of 16
        # tokens has 2 places an expert at the config's capacity factor, so
        # the pair runs where nothing drops
        B_D, P_D, N_D = sz.CHIP_DECODE_BATCH, sz.CHIP_PROMPT_LEN, sz.CHIP_NEW_TOKENS
        n_patches = cfg.vlm.n_patches if cfg.family == "vlm" else 0
        prompt_batch = concrete_batch(
            cfg, ShapeSpec("chip_decode", n_patches + P_D, B_D, "prefill"),
            seed=1, device=dev)
        prompts = prompt_batch["tokens"]
        toks, counts, _ = counted(lambda: greedy_decode(model, prompts, N_D,
                                                        P_D + N_D + 1))
        check(not any(counts.values()), f"{cfg.name} greedy_decode launched {counts}")
        check(toks.shape == (B_D, N_D) and toks.dtype == torch.int32
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"{cfg.name} greedy_decode returned {tuple(toks.shape)} {toks.dtype}")
        pair_cfg = cfg
        if cfg.family == "moe":
            pair_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_routed / cfg.moe.top_k))
            check(tmoe.capacity(P_D, pair_cfg) == P_D, "no-drop capacity")

        # the ssm and hybrid prefills take a multiple of the SSD chunk, so
        # their pair runs over CHIP_CHECK_SEQ tokens; the vlm's decode (text
        # only) is not comparable with its prefill (patches prepended), so
        # it is held card against CPU below instead
        pair_tokens = prompts
        if hasattr(sz, "CHIP_CHECK_SEQ"):
            pair_tokens = concrete_batch(
                cfg, ShapeSpec("chip_check", sz.CHIP_CHECK_SEQ, B_D, "prefill"),
                seed=1, device=dev)["tokens"]
        if cfg.family != "vlm":
            frames = prompt_batch.get("frames")
            # the bf16 pair is reported only; over the ssm and hybrid
            # families' 256 host-bound steps it is left out for time
            bf_err = bf_agree = None
            if not hasattr(sz, "CHIP_CHECK_SEQ"):
                bf_err, bf_agree = decode_vs_prefill(params, pair_cfg, pair_tokens,
                                                     frames)
            f32_err, f32_agree = decode_vs_prefill(
                params, dataclasses.replace(pair_cfg, activation_dtype="float32"),
                pair_tokens, frames)
            check(f32_err <= LM_F32_LOGIT_TOL,
                  f"{cfg.name} f32 decode vs prefill max |d| {f32_err}")
            r.update(decode_vs_prefill=dict(
                positions=pair_tokens.shape[1], bf16=bf_err, bf16_argmax_agree=bf_agree,
                f32=f32_err, f32_argmax_agree=f32_agree))

        if cfg.family == "moe":
            # the share of assignments the prefill drops at the config's
            # capacity factor, read from each MoE layer's own input
            real = tmoe.moe_ffn
            drops = []

            def counting(p, x, cfg_):
                _, _, ids = tmoe.route(p, x, cfg_)
                keep = tmoe.dispatch_slots(ids, cfg_.moe.n_routed,
                                           tmoe.capacity(x.shape[1], cfg_))[2]
                drops.append(((~keep).sum().item(), keep.numel()))
                return real(p, x, cfg_)

            tmoe.moe_ffn = counting
            try:
                with torch.no_grad():
                    model.prefill(batch)
            finally:
                tmoe.moe_ffn = real
            r.update(capacity=tmoe.capacity(S, cfg),
                     dropped_share=sum(d for d, _ in drops) / sum(n for _, n in drops),
                     dropped_share_by_layer=[d / n for d, n in drops])

        # timings: prefill (host clock, median of 5 after a warm-up) and
        # decode (median of 3: a greedy_decode is 47 host-bound steps, and
        # nine archs' repeats are a minute of the script), then one
        # profiled prefill: where its device time goes
        r["prefill_ms"] = walls_ms(lambda: model.prefill(batch))
        r["prefill_profile"] = profile_shares(lambda: model.prefill(batch))
        r["tokens_per_s"] = B * S / r["prefill_ms"] * 1e3
        steps = P_D + N_D - 1
        r["decode_ms_per_step"] = walls_ms(
            lambda: greedy_decode(model, prompts, N_D, P_D + N_D + 1), n=3) / steps
        r["peak_bytes"] = torch.cuda.max_memory_allocated() - base_mem
        dp = r.get("decode_vs_prefill")
        log(f"archs {cfg.name} ({cfg.n_layers} of {sz.CONFIG.n_layers} layers, "
            f"{r['n_params'] / 1e9:.3f} B params): prefill B={B} S={S} "
            f"{r['prefill_ms']:.3f} ms ({r['tokens_per_s']:.0f} tokens/s), "
            f"flash launches {n_flash} (by design {by_design}); greedy_decode "
            f"{B_D}x{N_D} {r['decode_ms_per_step']:.3f} ms per step; "
            + (f"decode vs prefill over {dp['positions']} positions max |d| "
               f"{dp['f32']:.4g} in f32 (argmax {dp['f32_argmax_agree']}/{B_D})"
               + (f", {dp['bf16']:.4g} in bf16 (argmax {dp['bf16_argmax_agree']}/{B_D})"
                  if dp["bf16"] is not None else ", bf16 not run")
               + (f", capacity factor {pair_cfg.moe.capacity_factor:g}"
                  if cfg.family == "moe" else "")
               if dp else "decode (text only) not comparable with the prefill")
            + f"; peak {r['peak_bytes'] / 2**30:.2f} GiB above the phase's base"
            + (f"; prefill drops {100 * r['dropped_share']:.3f}% of assignments "
               f"at C={r['capacity']} (per layer "
               + ", ".join(f"{100 * x:.2f}" for x in r["dropped_share_by_layer"]) + ")"
               if cfg.family == "moe" else ""))

        pr = r["prefill_profile"]
        if pr:
            log(f"profile {cfg.name} prefill, profiler on: wall {pr['wall_ms']:.3f} ms, "
                f"device busy {pr['busy_ms']:.3f} ms ({100 * pr['busy_ms'] / pr['wall_ms']:.1f}%); "
                f"GEMMs {pr['gemm_ms']:.3f} ms ({100 * pr['gemm_ms'] / pr['busy_ms']:.1f}%), "
                f"flash {pr['flash_ms']:.3f} ({100 * pr['flash_ms'] / pr['busy_ms']:.1f}%), "
                f"the rest {pr['other_ms']:.3f} ({100 * pr['other_ms'] / pr['busy_ms']:.1f}%); "
                + "; ".join(f"{k} {v:.3f}" for k, v in pr["top"]))
        else:
            log(f"profile {cfg.name} prefill: the profiler recorded no device time "
                "(not measured)")

        if n_flash:
            # the kernel alone at this prefill's folded shape, and the
            # prefill's first layers in f32 activations against the same
            # with the plain version in the kernel's place
            gen = torch.Generator(device=dev).manual_seed(3)
            acfg = tfm._shared_cfg(cfg) if cfg.family == "hybrid" else cfg
            H, KV, D = acfg.n_heads, acfg.n_kv_heads, acfg.hd
            fq, fk, fv = kops._fold_gqa(*(
                torch.randn((B, h, S, D), generator=gen, device=dev,
                            dtype=torch.bfloat16) for h in (H, KV, KV)))
            _build.reset_launches()
            got = kernel_fwd(fq, fk, fv, causal=True, block_q=128, block_k=128,
                             schedule=cfg.flash_schedule)
            sync()
            check(dict(_build.FLASH_DESIGN_LAUNCHES) == {"sm90": 1, "simple": 0},
                  f"flash at {tuple(fq.shape)} ran {dict(_build.FLASH_DESIGN_LAUNCHES)}")
            err = flash_err(got, ref.flash_attention_ref(fq, fk, fv, causal=True),
                            f"{tuple(fq.shape)} bf16 causal, {cfg.name}'s prefill")
            BH = fq.shape[0]
            ops_ = 4 * D * BH * S * (S + 1) // 2
            nbytes = 2 * (2 * fq.numel() + 2 * fk.numel() * KV // H)
            t_o, t_b = ops_ / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
            q4, k4, v4 = (t.view(B, H, S, D) for t in (fq, fk, fv))
            fl = dict(
                shape=[BH, S, D], max_abs_err=err,
                ms=events_ms(lambda: kernel_fwd(fq, fk, fv, causal=True, block_q=128,
                                                block_k=128, schedule=cfg.flash_schedule),
                             inner=10),
                plain_ms=events_ms(lambda: ref.flash_attention_ref(fq, fk, fv, causal=True),
                                   reps=3, inner=1),
                library_ms=events_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), inner=10),
                bound_ms=1e3 * max(t_o, t_b),
                bound_by="operations" if t_o >= t_b else "bytes")
            log(f"flash_attention_fwd at {cfg.name}'s prefill {tuple(fl['shape'])} bf16 "
                f"causal (GQA rep {H // KV}), Hopper design: max |d| against the plain "
                f"version {err:.3g}; "
                f"{fl['ms']:.4f} ms ({ops_ / fl['ms'] / 1e9:.1f} TFLOP/s); plain "
                f"{fl['plain_ms']:.3f} ms; SDPA {fl['library_ms']:.4f} ms; bound "
                f"{fl['bound_ms']:.4f} ms by {fl['bound_by']}")
            r["flash"] = fl
            n32 = getattr(sz, "CHIP_F32_LAYERS", 0)
            if n32:
                p32, c32 = first_layers(params, cfg, n32)
                c32 = dataclasses.replace(c32, activation_dtype="float32")
                (l_k, _, by32) = counted(lambda: with_fwd(
                    kernel_fwd, lambda: tfm.prefill(p32, batch, c32)))
                check(by32 == {"sm90": 0, "simple": n32},
                      f"{cfg.name} f32 prefill flash launches {by32}")
                l_p = with_fwd(plain_fwd, lambda: tfm.prefill(p32, batch, c32))
                f32_err = (l_k - l_p).abs().max().item()
                check(f32_err <= LM_F32_LOGIT_TOL,
                      f"{cfg.name} f32 prefill: kernel vs plain version max |d| {f32_err}")
                r["f32_prefill"] = dict(layers=n32, max_abs_err=f32_err,
                                        logit_std=l_p.std().item())
                log(f"archs {cfg.name} {n32} layers in f32 activations B={B} S={S}: "
                    f"{n32} simple flash launches; logits with the kernel against "
                    f"its plain version max |d| {f32_err:.4g} (std {l_p.std().item():.4g})")

        if hasattr(sz, "CHIP_WINDOW_LAYERS"):
            # past the window: 6 layers (five local, one global), the cache
            # filled by teacher-forced decode steps to 520 positions; the
            # last step against the prefill's last position
            pw, cw = first_layers(params, cfg, sz.CHIP_WINDOW_LAYERS)
            flags = [cw.layer_is_global(i) for i in range(cw.n_layers)]
            check(flags == [False] * 5 + [True], f"gemma3 window layers {flags}")
            n_w = sz.CHIP_WINDOW_SEQ
            check(n_w > cw.sliding_window, "the window check runs past the window")
            wt = concrete_batch(cw, ShapeSpec("chip_window", n_w, 2, "prefill"),
                                seed=2, device=dev)["tokens"]
            w32 = dataclasses.replace(cw, activation_dtype="float32")
            w_err, _ = decode_vs_prefill(pw, w32, wt)
            w_bf, _ = decode_vs_prefill(pw, cw, wt)
            check(w_err <= LM_F32_LOGIT_TOL,
                  f"gemma3 window: f32 decode vs prefill max |d| {w_err}")
            check(w_bf <= LM_LOGIT_TOL,
                  f"gemma3 window: bf16 decode vs prefill max |d| {w_bf}")
            with torch.no_grad():
                unwindowed = (tfm.prefill(pw, {"tokens": wt}, dataclasses.replace(
                    w32, sliding_window=None)) - tfm.prefill(pw, {"tokens": wt}, w32))
            r["window"] = dict(layers=cw.n_layers, positions=n_w, f32=w_err, bf16=w_bf,
                               without_window=unwindowed.abs().max().item())
            log(f"archs {cfg.name} window: {cw.n_layers} layers (global {flags}), "
                f"{n_w} decode steps past the {cw.sliding_window}-position window: "
                f"last step against the prefill max |d| {w_err:.4g} in f32, "
                f"{w_bf:.4g} in bf16; the f32 prefill without the window differs "
                f"by {r['window']['without_window']:.4g}")

            # temperature sampling: the step's token is the argmax the host
            # computes from the same logits and noise; one seed, one draw
            serve = make_serve_step(model, sample=True, temperature=0.7)
            cache = model.init_cache(B_D, 2, torch.float32)
            b0 = {"tokens": prompts[:, :1], "cur": 0}
            g = gumbel_noise((B_D, cfg.vocab_padded),
                             torch.Generator(device=dev).manual_seed(5), dev)
            with torch.no_grad():
                lg, cache = model.decode(cache, b0)
            nxt, _ = serve(cache, {**b0, "gumbel": g})
            want = torch.argmax(lg[:, -1].cpu() / 0.7 + g.cpu(), dim=-1)
            check(torch.equal(nxt.cpu().long(), want),
                  f"sampled {nxt.tolist()} != host argmax {want.tolist()}")

            def sampled(seed):
                step = make_serve_step(model, sample=True, temperature=0.7,
                                       generator=torch.Generator(device=dev).manual_seed(seed))
                c = model.init_cache(B_D, P_D + 1, torch.float32)
                return torch.stack([step(c, {"tokens": prompts[:, t:t + 1], "cur": t})[0]
                                    for t in range(P_D)], dim=1)

            s7 = sampled(7)
            check(torch.equal(s7, sampled(7)), "the same seed sampled other tokens")
            r["sampling"] = dict(host_argmax_equal=True, seed_repeats=True,
                                 other_seed_equal=bool(torch.equal(s7, sampled(8))))
            log(f"archs {cfg.name} sampling at temperature 0.7: tokens equal to the "
                f"host's argmax of logits/0.7 + the given noise; seed 7 twice "
                f"equal; seed 8 equal to seed 7: {r['sampling']['other_seed_equal']}")

        if cfg.family == "moe":
            # no kernel holds MoE or MLA: 2 layers (the dense one and one MoE
            # layer) in f32 on the card against the same weights on the CPU,
            # stage by stage: each layer and the head take the card's input
            # on both devices. End to end the two may differ by more, and
            # are reported: routing is discontinuous (a token whose K-th and
            # (K+1)-th experts lie within the devices' rounding may take
            # other experts and shift which assignments drop)
            p2, c2 = first_layers(params, cfg, sz.CHIP_CPU_LAYERS)
            c2 = dataclasses.replace(c2, activation_dtype="float32")
            t2 = concrete_batch(c2, ShapeSpec("chip_cpu", sz.CHIP_CPU_SEQ, 1, "prefill"),
                                seed=3, device=dev)["tokens"]
            p_cpu = tree_map(lambda t: t.cpu(), p2)

            def stages(p_, toks_, given=None):
                """Each layer's output and the logits (on the CPU), the
                routing of each MoE layer (each token's experts, sorted);
                with ``given`` (the inputs of the layers and of the head),
                each stage takes its given input."""
                seen, real = [], tmoe.route

                def rec(pp, x, cc):
                    out = real(pp, x, cc)
                    seen.append(out[2].sort(-1).values.cpu())
                    return out

                tmoe.route = rec
                outs = []
                try:
                    with torch.no_grad():
                        x = embed(p_["embed"], toks_, torch.float32)
                        pos = torch.arange(toks_.shape[1], device=x.device)
                        layers = [(pl, bool(fl)) for n, fl in tfm._stacks(c2)
                                  for pl, fl in zip(tfm._layers(p_[n]), fl)]
                        for i, (pl, fl) in enumerate(layers):
                            if given is not None:
                                x = given[i].to(x.device)
                            x = tfm._attn_layer_train(pl, x, c2, fl, pos)[0]
                            outs.append(x.cpu())
                        if given is not None:
                            x = given[-1].to(x.device)
                        h = rmsnorm(x, p_["final_norm"], c2.norm_eps)
                        lg = tfm._mask_pad(unembed(tfm._unembed_w(p_, c2), h), c2)
                finally:
                    tmoe.route = real
                return outs, lg.cpu(), seen

            on_card, lg_card, seen_card = stages(p2, t2)
            with torch.no_grad():
                given = [embed(p2["embed"], t2, torch.float32).cpu()] + on_card
            on_cpu, lg_cpu, _ = stages(p_cpu, t2.cpu(), given)
            stage_errs = [(a - b).abs().max().item()
                          for a, b in zip(on_card + [lg_card], on_cpu + [lg_cpu])]
            _, lg_e2e, seen_e2e = stages(p_cpu, t2.cpu())
            rerouted = sum(int((a != b).any(-1).sum())
                           for a, b in zip(seen_card, seen_e2e))
            e2e_err = (lg_card - lg_e2e).abs()
            worst = divmod(int(e2e_err.argmax()), lg_card.shape[-1])
            check(max(stage_errs) <= CARD_CPU_TOL,
                  f"{cfg.name} f32 stages card vs CPU on one input max |d| {stage_errs}")
            r["card_vs_cpu"] = dict(layers=c2.n_layers, seq=sz.CHIP_CPU_SEQ,
                                    stage_max_abs_err=stage_errs,
                                    end_to_end_max_abs_err=e2e_err.max().item(),
                                    rerouted_tokens=rerouted,
                                    logit_std=lg_cpu.std().item())
            log(f"archs {cfg.name} {c2.n_layers} layers f32 B=1 S={sz.CHIP_CPU_SEQ}, "
                f"card against CPU: each stage on the card's input (layers, then the "
                f"head) max |d| {', '.join(f'{e:.4g}' for e in stage_errs)}; end to end "
                f"{e2e_err.max().item():.4g} (at position {worst[0]}, token "
                f"{worst[1]}; positions over 1e-4: "
                f"{int((e2e_err.amax(-1) > 1e-4).sum())}), tokens routed to other "
                f"experts {rerouted}; logit std {lg_cpu.std().item():.4g}")

        if cfg.family in ("ssm", "hybrid"):
            # no kernel holds Mamba2: its first layer in f32 on the card
            # against the same on the CPU, on one input of two SSD chunks
            c32 = dataclasses.replace(cfg, activation_dtype="float32")
            p0 = {k: v[0] for k, v in params["layers"].items()}
            x = torch.randn((1, sz.CHIP_CPU_SEQ, cfg.d_model), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(4))
            with torch.no_grad():
                y_card = tmamba.mamba2_block(p0, x, c32).cpu()
                y_cpu = tmamba.mamba2_block({k: v.cpu() for k, v in p0.items()},
                                            x.cpu(), c32)
            m_err = (y_card - y_cpu).abs().max().item()
            check(bool(torch.isfinite(y_card).all()) and m_err <= CARD_CPU_TOL,
                  f"{cfg.name} Mamba2 layer card vs CPU max |d| {m_err}")
            r["mamba_layer_card_vs_cpu"] = dict(seq=sz.CHIP_CPU_SEQ, max_abs_err=m_err,
                                                out_std=y_cpu.std().item())
            log(f"archs {cfg.name} Mamba2 layer 0 f32 B=1 S={sz.CHIP_CPU_SEQ} "
                f"(chunk {cfg.ssm.chunk}), card against CPU: max |d| {m_err:.4g} "
                f"(output std {y_cpu.std().item():.4g})")

            # long_500k: one decode step at B=1 at the last of 524,288
            # positions (mamba2: an f32 state of the same size at any
            # position; the hybrid: a bf16 cache holding the shared block's
            # K/V for every position)
            n_long = sz.CHIP_LONG_LEN
            ldt = torch.float32 if cfg.family == "ssm" else torch.bfloat16
            cache = model.init_cache(1, n_long, ldt)
            cache_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(cache))
            step = {"tokens": prompts[:1, :1], "cur": n_long - 1}
            with torch.no_grad():
                lg, _ = model.decode(cache, step)
            check(bool(torch.isfinite(lg).all()), f"{cfg.name} long_500k logits not finite")
            ms = walls_ms(lambda: model.decode(cache, step))
            r["long_500k"] = dict(max_len=n_long, cur=n_long - 1, cache_dtype=str(ldt),
                                  cache_bytes=cache_bytes, ms_per_step=ms)
            log(f"archs {cfg.name} long_500k: one decode step at B=1, cur={n_long - 1}, "
                f"{str(ldt)} cache of {cache_bytes / 1e6:.1f} MB: {ms:.3f} ms; "
                f"logits finite")
            del cache

        if cfg.family == "vlm":
            # the vlm's prefill (patches through the projector, then the LM)
            # in f32 activations: its first layers on the card (the simple
            # flash design) against the same on the CPU (the plain version)
            p2, c2 = first_layers(params, cfg, sz.CHIP_CPU_LAYERS)
            c2 = dataclasses.replace(c2, activation_dtype="float32")
            b2 = concrete_batch(c2, ShapeSpec("chip_cpu", sz.CHIP_CPU_SEQ, 1, "prefill"),
                                seed=3, device=dev)
            (lg_card, _, by2) = counted(lambda: with_fwd(
                kernel_fwd, lambda: tfm.prefill(p2, b2, c2)))
            check(by2 == {"sm90": 0, "simple": c2.n_layers},
                  f"{cfg.name} f32 prefill flash launches {by2}")
            with torch.no_grad():
                lg_cpu = tfm.prefill(tree_map(lambda t: t.cpu(), p2),
                                     {k: v.cpu() for k, v in b2.items()}, c2)
            # its logits' std is 1.8 (d_model 8192), three times smollm's:
            # the bound scales with it
            v_err = (lg_card.cpu() - lg_cpu).abs().max().item()
            v_tol = CARD_CPU_TOL * max(1.0, lg_cpu.std().item())
            check(v_err <= v_tol,
                  f"{cfg.name} f32 prefill card vs CPU max |d| {v_err} > {v_tol}")
            r["card_vs_cpu"] = dict(layers=c2.n_layers, seq=sz.CHIP_CPU_SEQ,
                                    patches=cfg.vlm.n_patches, max_abs_err=v_err,
                                    tol=v_tol, logit_std=lg_cpu.std().item())
            log(f"archs {cfg.name} {c2.n_layers} layers f32 prefill B=1 "
                f"S={sz.CHIP_CPU_SEQ} ({cfg.vlm.n_patches} patches + "
                f"{sz.CHIP_CPU_SEQ - cfg.vlm.n_patches} tokens), card against CPU: "
                f"max |d| {v_err:.4g} (bound {v_tol:.4g}: 1e-4 per unit of the "
                f"logits' std {lg_cpu.std().item():.4g})")

        r["seconds"] = time.perf_counter() - t0
        return r

    def profile_shares(fn) -> dict:
        """One profiled call of ``fn``: wall and device-busy ms, the ms of
        GEMMs, of the flash kernel and of the rest, and the five longest
        kernels (empty when the trace holds no device time)."""
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            sync()
            wall = 1e3 * (time.perf_counter() - t1)
        by_name = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0
                   and not e.is_user_annotation}
        if not by_name:
            return {}
        flash = sum(v for k, v in by_name.items() if "flash_fwd" in k)
        gemm = sum(v for k, v in by_name.items()
                   if GEMM_KERNEL.search(k) and "flash" not in k)
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
        return dict(wall_ms=wall, busy_ms=busy, gemm_ms=gemm, flash_ms=flash,
                    other_ms=busy - gemm - flash,
                    top=[[k[:80], v] for k, v in top])

    readings = {}
    for name in ARCH_MODULES:
        sz = importlib.import_module(f"repro_torch.configs.{name}")
        readings[sz.CONFIG.name] = serve_arch(sz)
        torch.cuda.empty_cache()
    total_flash = sum(r["flash_launches"] for r in readings.values())
    log(f"archs phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=total_flash, archs=readings)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import smollm_360m as lm_sizes
    from repro_torch.configs.gol3d import (CHIP_DISTRIBUTED,
                                           CHIP_DISTRIBUTED_STEPS,
                                           CHIP_MAIN, CHIP_MAIN_STEPS,
                                           CHIP_MESHES, CHIP_ORDERINGS,
                                           CHIP_REPACK, CHIP_REPACK_STEPS)
    from repro_torch.core import (apply_ordering, as_boundary, axes_periodic,
                                  blockize, blockize_fields, blockize_with_halo,
                                  boundary_face_table_device, dirichlet,
                                  extended_neighbor_table_device,
                                  group_table_device, mixed,
                                  neighbor_table_device, store_spec)
    from repro_torch.configs.registry import ShapeSpec, concrete_batch
    from repro_torch.core.layout import _perm_device
    from repro_torch.core.surfaces import run_stats, surface_path_indices
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stencil3d as K
    from repro_torch.kernels.ops import uniform_weights
    from repro_torch.kernels import flash_attn as FA
    from repro_torch.kernels.flash_attn import flash_attention_fwd, flash_design
    from repro_torch.kernels.sfc_gather import gather_rows
    from repro_torch.models import Model
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import greedy_decode
    from repro_torch.stencil.domain import make_stencil_mesh
    from repro_torch.stencil.gol3d import Gol3d
    from repro_torch.stencil.halo import (core_of, extended_store, fill_shells,
                                          shard_boundary_flags, shard_state,
                                          to_store)
    from repro_torch.stencil.pipeline import (DistributedPipeline,
                                              ResidentPipeline,
                                              checkpoint_traffic_fraction,
                                              fused_items_per_launch,
                                              resident_bytes_per_step)
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.launch.faults import (KILL_EXIT, FaultPlan, SimulatedCrash,
                                           bitflip_chunk, initial_state,
                                           state_crc)
    from repro_torch.stencil.runner import (CheckpointedRun, RunHealthError,
                                            health_check)
    from repro_torch.configs.gol3d import (CHIP_ROI, CHIP_ROI_CACHE_BLOCKS,
                                           CHIP_ROI_DEADLINE_S, CHIP_ROI_FAULTS,
                                           CHIP_ROI_MAX_IN_FLIGHT, CHIP_ROI_REPS,
                                           CHIP_ROI_SLOW_DEADLINE_S,
                                           CHIP_ROI_SLOW_S, CHIP_ROI_STEPS,
                                           roi_suite)
    from repro_torch.launch.faults import ServeFaultPlan
    from repro_torch.launch.serve import _demo_rois
    from repro_torch.serve import (QUERY_STATUSES, StencilQueryService,
                                   StoreLayout, ranges_to_blocks, roi_model,
                                   roi_to_ranges)
    FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)  # faults F2 and F3

    KINDS = tuple(spec.name for spec in CHIP_ORDERINGS)
    M_MAIN, T_MAIN, G_MAIN = CHIP_MAIN.M, CHIP_MAIN.block_T, CHIP_MAIN.g
    S_MAIN, K_MAIN = CHIP_MAIN.substeps, CHIP_MAIN_STEPS
    TAPS = (2 * G_MAIN + 1) ** 3
    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    rng = np.random.default_rng(0)

    def bc_of(name):
        return {"periodic": "periodic", "dirichlet": dirichlet(0.5),
                "neumann0": "neumann0", "mixed": mixed(k="neumann0")}[name]

    def cube_for(rule, M, C=1):
        if rule == "gol":
            a = (rng.random((C, M, M, M)) < 0.3).astype(np.float32)
        else:
            a = rng.normal(size=(C, M, M, M)).astype(np.float32)
        return torch.from_numpy(a).to(dev)

    def cuda_ms(fn, reps=5, inner=10):
        """Median over ``reps`` of the mean CUDA-event time of ``inner`` calls."""
        fn()
        sync()
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            sync()
            times.append(e0.elapsed_time(e1) / inner)
        return statistics.median(times)

    def device_ms(fn, n=200, tries=3):
        """(ms, how): the device time per call of the kernels ``fn``
        launches — the sum of their durations in a profiler trace of ``n``
        calls, over ``n`` (how = "device"). For a kernel shorter than the
        host's cost of launching it, CUDA events around back-to-back calls
        measure the host instead. A trace can come back without device
        events; after ``tries`` such traces the time is taken with CUDA
        events around the ``n`` calls (how = "events", host cost included)."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        sync()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                sync()
            total = sum(e.self_device_time_total for e in prof.key_averages()
                        if str(e.device_type).endswith("CUDA")
                        and not e.is_user_annotation)
            if total > 0:
                return total / 1e3 / n, "device"
        log(f"the profiler recorded no device time in {tries} traces; "
            f"CUDA events around {n} calls instead")
        return cuda_ms(fn, reps=3, inner=n), "events"

    def bound(nbytes, flops, peak=F32_FLOP_PER_S):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, flops / peak
        return (1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations")

    def one_launch_of(counts, design, fn, what):
        """fn(), after checking that it made one launch, of ``design``, by
        the per-design launch counts ``counts``."""
        before = dict(counts)
        out = fn()
        ran = {d_: n - before[d_] for d_, n in counts.items()}
        check(ran == {**{d_: 0 for d_ in ran}, design: 1},
              f"{what}: launches by design {ran}, want one {design}")
        return out

    def same_bits(got, want):
        """Bit-equal wherever ``want`` is a number, and NaN exactly where
        it is NaN (a NaN's sign and payload follow the arithmetic)."""
        if got.shape != want.shape or got.dtype != want.dtype:
            return False
        nan_g, nan_w = torch.isnan(got.float()), torch.isnan(want.float())
        width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[got.element_size()]
        gb, wb = got.contiguous().view(width), want.contiguous().view(width)
        return torch.equal(nan_g, nan_w) and torch.equal(gb[~nan_w], wb[~nan_w])

    def fp8_cube(rule, M_, C=1):
        """An f32 cube for an fp8 store: the rule's values with, off gol,
        a fifth of the sites in ±[440, 480] (where e4m3fn's 448 and its NaN
        above 464 lie) and one site in 200 NaN."""
        a = cube_for(rule, M_, C)
        if rule != "gol":
            big = torch.from_numpy(rng.random(a.shape) < 0.2).to(dev)
            mag = torch.from_numpy(rng.uniform(440, 480, a.shape).astype(np.float32)
                                   * rng.choice([-1.0, 1.0], a.shape).astype(np.float32))
            a = torch.where(big, mag.to(dev), a)
        nan = torch.from_numpy(rng.random(a.shape) < 0.005).to(dev)
        return a.masked_fill(nan, float("nan"))

    def stencil_on(design, fn, what):
        """fn(), one fused or resident launch of ``design``."""
        return one_launch_of(_build.STENCIL_DESIGN_LAUNCHES, design, fn, what)

    def step_design(T, g, S, C, bc):
        """The design ``stencil_step_fused`` launches on the f32 store of a
        whole cube of an even number of blocks per edge under ``bc``: the
        group design where the contract is periodic and it has an
        instance."""
        return K.fused_design(T, g, S, C, cube=not as_boundary(bc).clamped)

    def blocks_on(design, fn, what):
        """fn(), one repack tap-sum launch of ``design``."""
        return one_launch_of(_build.BLOCKS_DESIGN_LAUNCHES, design, fn, what)

    # ---------------------------------------------------------------- set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    # What needs no kernel runs while nvcc builds them: the dry run's count
    # on meta (a process that sees no card, read by the mesh phase), and
    # the row plans of the M=256 deep faces that the gather_rows check and
    # timings read, the orderings' permutations and the pack timings'
    # faces (host arithmetic, memoised), each on a thread of its own.
    bg_work = tempfile.mkdtemp(prefix="chip_smoke_bg_")
    background = {"work": bg_work, "dryrun_meta": start_dryrun_meta(bg_work)}

    def cleanup():
        for child in [background["dryrun_meta"], *PROCS]:
            if child.poll() is None:
                child.kill()
                child.wait()
        if "shared" in background:
            with contextlib.suppress(BaseException):
                background["shared"]()
        shutil.rmtree(bg_work, ignore_errors=True)

    atexit.register(cleanup)
    t0 = time.perf_counter()
    built = in_background(_build.build)

    def orderings_perms():
        """The cube <-> path permutations of the main paths' orderings
        (host arithmetic, memoised on the host and the card by
        core.layout; numpy lets go of the GIL, so this thread and the
        face rows below overlap)."""
        for spec in CHIP_ORDERINGS:
            for inverse in (False, True):
                _perm_device(spec, M_MAIN, inverse, dev)
        for inverse in (False, True):
            _perm_device(CHIP_REPACK.ordering, CHIP_REPACK.M, inverse, dev)

    perms = in_background(orderings_perms, nice=HOST_WORK_NICE)
    M_D, T_D = CHIP_DISTRIBUTED.M, CHIP_DISTRIBUTED.block_T

    @functools.cache
    def face_rows(kind, h, face):
        """(path indices, row plan on the card) of one deep face, cached:
        the gather_rows check and the gather timings read them."""
        hspec = store_spec(kind, T_D)
        idx = surface_path_indices(hspec, M_D, h, face)
        rows, _ = kops._row_plan(idx, LINE, (hspec, M_D, h, face))
        return idx, torch.from_numpy(np.array(rows)).to(dev)

    def all_face_rows():
        for kind in KINDS:
            for h in (1, 2, 4):
                for face in FACES:
                    face_rows(kind, h, face)

    def pack_faces():
        """The faces the pack timings read, each ordering's of widths 1
        and 4 on the M=256 cube, with their row plans (memoised)."""
        for spec in CHIP_ORDERINGS:
            for g_p in (1, 4):
                for face in FACES:
                    kops._row_plan(surface_path_indices(spec, M_D, g_p, face), LINE,
                                   (spec, M_D, g_p, face))

    packs = in_background(pack_faces, nice=HOST_WORK_NICE)
    in_background(all_face_rows, nice=HOST_WORK_NICE)()
    perms()
    packs()
    t_rows = time.perf_counter() - t0
    reports = built()
    log(f"build: {time.perf_counter() - t0:.2f} s, in parallel: "
        + ", ".join(f"{name} {sec:.1f} s" for name, (sec, _) in reports.items())
        + f" (flags {' '.join(_build.NVCC_FLAGS)}); meanwhile the deep faces' "
        f"row plans at M={M_D}, the orderings' permutations and the pack "
        f"timings' faces ({t_rows:.1f} s)")
    for name, (_, text) in reports.items():
        for line in text.splitlines():
            entry = kernel_name(line)
            if "Compiling entry function" in line and entry:
                log(f"  ptxas {name}: {entry}")
            elif "Used" in line or "spill" in line:
                log(f"  ptxas {name}:   {line.split(':', 1)[-1].strip()}")
    def sass_of(name):
        return subprocess.run(
            [str(Path(_build.nvcc_path()).resolve().parent / "cuobjdump"), "-sass",
             str(_build._lib_path(name))],
            capture_output=True, text=True, check=True, timeout=300).stdout

    # the Hopper flash design really runs on the tensor cores and TMA
    sass = sass_of("flash_attn_sm90")
    n_hgmma, n_tma = sass.count("HGMMA"), sass.count("UTMALDG")
    check(n_hgmma > 0 and n_tma > 0,
          f"flash_attn_sm90 SASS holds {n_hgmma} HGMMA and {n_tma} UTMALDG")
    log(f"flash_attn_sm90 SASS: {n_hgmma} HGMMA, {n_tma} UTMALDG instructions")
    # and so does the Hopper backward, its lse and Δ by 1-D bulk copies
    sass = sass_of("flash_attn_bwd_sm90")
    n_hgmma, n_tma, n_blk = sass.count("HGMMA"), sass.count("UTMALDG"), sass.count("UBLKCP")
    check(n_hgmma > 0 and n_tma > 0 and n_blk > 0,
          f"flash_attn_bwd_sm90 SASS holds {n_hgmma} HGMMA, {n_tma} UTMALDG and "
          f"{n_blk} UBLKCP")
    log(f"flash_attn_bwd_sm90 SASS: {n_hgmma} HGMMA, {n_tma} UTMALDG, {n_blk} UBLKCP "
        f"instructions")
    # the Hopper stencil design: every instance of its block and group
    # designs built, and no contracted multiply-add anywhere (bit-exactness
    # rests on separate FMUL and FADD)
    sass = sass_of("stencil3d_sm90")
    n_kern = len(re.findall(r"Function : \S*fused_sm90_kernel", sass))
    n_group = len(re.findall(r"Function : \S*fused_group_sm90_kernel", sass))
    n_ffma, n_fmul = sass.count("FFMA"), sass.count("FMUL")
    check(n_kern == SM90_STENCIL_KERNELS and n_group == SM90_GROUP_KERNELS
          and n_ffma == 0 and n_fmul > 0,
          f"stencil3d_sm90 SASS holds {n_kern} block and {n_group} group kernels, "
          f"{n_ffma} FFMA")
    log(f"stencil3d_sm90 SASS: {n_kern} block and {n_group} group kernels, "
        f"{n_ffma} FFMA, {n_fmul} FMUL, {sass.count('LDGSTS')} LDGSTS (cp.async) "
        f"instructions")
    # the Hopper repack design: every instance built, no contracted
    # multiply-add, and its windows fed by 1-D bulk copies (cp.async.bulk,
    # UBLKCP in the SASS)
    sass = sass_of("stencil3d_blocks_sm90")
    n_kern = len(re.findall(r"Function : \S*blocks_sm90_kernel", sass))
    n_ffma, n_fmul, n_blk = sass.count("FFMA"), sass.count("FMUL"), sass.count("UBLKCP")
    check(n_kern == SM90_BLOCKS_KERNELS and n_ffma == 0 and n_fmul > 0 and n_blk > 0,
          f"stencil3d_blocks_sm90 SASS holds {n_kern} kernels, {n_ffma} FFMA, "
          f"{n_blk} UBLKCP; its bulk and TMA opcodes: "
          f"{sorted(set(re.findall(r'[A-Z]*(?:BLK|BULK|TMA)[A-Z.0-9]*', sass)))}")
    log(f"stencil3d_blocks_sm90 SASS: {n_kern} kernels, {n_ffma} FFMA, {n_fmul} "
        f"FMUL, {n_blk} UBLKCP (bulk copy) instructions")

    # The CLIs a user runs, each a process of its own on the card, start
    # now and run beside the checks below, which time nothing; the slices
    # that report them wait for them: the faults CLI killed at step 6 and
    # resumed by a second process, the elastic CLI's reshard, the serve
    # CLI twice and the train CLI; and the shared-card backends' reading
    # (two processes a backend, a moment of the card each).
    background["shared"] = in_background(shared_card_backends)
    K_C, IV = CHIP_MAIN_STEPS, CKPT_INTERVAL
    cli_dir = os.path.join(bg_work, "cli")
    d5 = os.path.join(cli_dir, "run5")
    fault_args = ("--M", str(M_MAIN), "--T", str(T_MAIN), "--S", str(S_MAIN),
                  "--steps", str(K_C), "--interval", str(IV), "--ckpt-dir", d5)

    def faults_cli():
        r = run_cli("repro_torch.launch.faults", *fault_args, "--kill-at", "6",
                    "--kill-mode", "exit")
        return r, CK.latest_step(d5), run_cli("repro_torch.launch.faults", *fault_args)

    background["faults"] = in_background(faults_cli)
    background["elastic"] = in_background(lambda: run_cli(
        "repro_torch.launch.elastic", "--stencil", "--from-mesh", "2,2,2",
        "--to-mesh", "1,1,1", "--local-M", str(M_MAIN // 2),
        "--ckpt-dir", os.path.join(cli_dir, "run6"), timeout=900))
    # as given (a 100 ms deadline), then with a deadline the M=256
    # queries can meet and room for all 12
    serve_extras = ((), ("--deadline-ms", "2000", "--max-in-flight", "12"))
    background["serve"] = in_background(lambda: [run_cli(
        "repro_torch.launch.serve", "--stencil", "--M", str(CHIP_ROI.M), "--faults",
        *extra) for extra in serve_extras])
    background["train_cli"] = in_background(lambda: run_cli(
        "repro_torch.launch.train", "--arch", "smollm-360m", "--smoke", "--steps",
        "3", "--batch", "2", "--seq", "32", "--device", dev.type, "--ckpt-dir",
        os.path.join(bg_work, "train_cli")))

    # ------------------------------------------- kernels vs plain, on the card
    t0 = time.perf_counter()
    M, n_cmp = 64, 0
    cases = [(k, S, r, b, 8, 1) for k in KINDS for S in (1, 2, 4)
             for r in ("gol", "jacobi", "wave") for b in BCS]
    cases += [("hilbert", 2, r, b, 8, 2) for r in ("gol", "jacobi", "wave")
              for b in BCS]
    for kind, S, rule, bcn, T, g in cases:
        C = 2 if rule == "wave" else 1
        cube = cube_for(rule, M, C)
        store = blockize_fields(cube, T, kind) if C == 2 else blockize(cube[0], T, kind)
        bc = bc_of(bcn)
        nbr = neighbor_table_device(kind, M // T, periodic=axes_periodic(bc), device=dev)
        bnd = boundary_face_table_device(kind, M // T, dev)
        w = uniform_weights(g, dev)
        got = stencil_on(step_design(T, g, S, C, bc),
                         lambda: K.stencil_step_fused(store, w, nbr, bnd, g=g, S=S,
                                                      rule=rule, bc=bc),
                         f"fused {kind} S={S} {rule} {bcn} T={T} g={g}")
        want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule, bc=bc, bnd=bnd)
        check(torch.equal(got, want),
              f"fused {kind} S={S} {rule} {bcn} T={T} g={g}: max |d| "
              f"{(got - want).abs().max().item()}")
        n_cmp += 1
    for kind in KINDS:
        for T, g in SUM_SHAPES:
            cube = cube_for("jacobi", M)[0]
            w = uniform_weights(g, dev)
            store = blockize(cube, T, kind)
            nbr = neighbor_table_device(kind, M // T, device=dev)
            res = stencil_on(K.fused_design(T, g, 1, 1),
                             lambda: K.stencil_sum_resident(store, w, nbr, g=g),
                             f"resident {kind} T={T} g={g}")
            halo = blockize_with_halo(cube, T, g, kind)
            rep = blocks_on(K.blocks_design(T, g),
                            lambda: K.stencil_sum_blocks(halo, w, g=g),
                            f"blocks {kind} T={T} g={g}")
            check(torch.equal(res, rep), f"resident != blocks {kind} T={T} g={g}")
            check(torch.equal(res, ref.stencil_sum_resident_ref(store, w, nbr)),
                  f"resident != plain {kind} T={T} g={g}")
            check(torch.equal(rep, ref.stencil_sum_ref(halo, w)),
                  f"blocks != plain {kind} T={T} g={g}")
            n_cmp += 3
    sync()
    log(f"kernels vs plain at M={M}: {n_cmp} comparisons bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")

    # stencil_sum_blocks in f32, bf16 and f16 blocks, with the neighbour
    # count's and with random weights, under the design blocks_design
    # gives, and forced onto the first design where the Hopper design runs
    # (the Hopper design has no instance for the last two shapes): both
    # designs bit-equal to the plain version, f32 out
    t0 = time.perf_counter()
    n_cmp, n_sm90 = 0, 0
    for T, g in SUM_SHAPES:
        s_ = 2 * g + 1
        cube = cube_for("jacobi", M)[0]
        weights = {"count": uniform_weights(g, dev), "random": torch.from_numpy(
            rng.normal(size=(s_, s_, s_)).astype(np.float32)).to(dev)}
        halo32 = blockize_with_halo(cube, T, g, "hilbert")
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            halo = halo32.to(dtype)
            design = K.blocks_design(T, g, dtype)
            for wname, w in weights.items():
                want = ref.stencil_sum_ref(halo, w)
                what = f"blocks {design} T={T} g={g} {dtype} {wname} weights"
                got = blocks_on(design, lambda: K.stencil_sum_blocks(halo, w, g=g), what)
                check(got.dtype == torch.float32 and torch.equal(got, want),
                      f"{what}: max |d| {(got - want).abs().max().item()}")
                n_cmp += 1
                n_sm90 += design == "sm90"
                if design == "sm90":
                    forced = torch.full_like(want, float("nan"))
                    blocks_on("simple", lambda: K._blocks_on_card(
                        "simple", halo, w, forced, g=g), f"{what}, forced simple")
                    check(torch.equal(forced, want), f"{what}, forced simple != plain")
                    n_cmp += 1
    check(n_sm90 == 24, f"{n_sm90} repack cases ran the Hopper design")
    sync()
    log(f"stencil_sum_blocks, both designs, f32/bf16/f16 at M={M}: {n_cmp} "
        f"comparisons bit-equal ({n_sm90} of the Hopper design; "
        f"{time.perf_counter() - t0:.1f} s)")

    # fault F2 on the card: the fused step on bf16 and f16 stores (gol and
    # wave, periodic and neumann0, S ∈ {1, 2}) and the resident tap sum on
    # them (random weights), bit-equal to their plain versions; fused_design
    # sends every half-precision store to the first design
    t0 = time.perf_counter()
    n_cmp, T, g = 0, 8, 1
    w_rand = torch.from_numpy(rng.normal(size=(3, 3, 3)).astype(np.float32)).to(dev)
    for dtype in (torch.bfloat16, torch.float16):
        for rule in ("gol", "wave"):
            C = 2 if rule == "wave" else 1
            cube = cube_for(rule, M, C).to(dtype)
            store = (blockize_fields(cube, T, "hilbert") if C == 2
                     else blockize(cube[0], T, "hilbert"))
            for bcn in ("periodic", "neumann0"):
                bc = bc_of(bcn)
                nbr = neighbor_table_device("hilbert", M // T,
                                            periodic=axes_periodic(bc), device=dev)
                bnd = boundary_face_table_device("hilbert", M // T, dev)
                w = uniform_weights(g, dev)
                for S in (1, 2):
                    what = f"fused {dtype} {rule} {bcn} S={S}"
                    check(K.fused_design(T, g, S, C, dtype) == "simple", what)
                    got = stencil_on("simple", lambda: K.stencil_step_fused(
                        store, w, nbr, bnd, g=g, S=S, rule=rule, bc=bc), what)
                    want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule,
                                                 bc=bc, bnd=bnd)
                    check(got.dtype == dtype and torch.equal(got, want),
                          f"{what}: max |d| {(got.float() - want.float()).abs().max().item()}")
                    n_cmp += 1
        store = blockize(cube_for("jacobi", M)[0].to(dtype), T, "hilbert")
        nbr = neighbor_table_device("hilbert", M // T, device=dev)
        got = stencil_on("simple", lambda: K.stencil_sum_resident(store, w_rand, nbr, g=g),
                         f"resident {dtype}")
        check(got.dtype == torch.float32
              and torch.equal(got, ref.stencil_sum_resident_ref(store, w_rand, nbr)),
              f"resident {dtype} != plain")
        n_cmp += 1
    sync()
    log(f"F2, bf16 and f16 stores at M={M}: {n_cmp} fused and resident "
        f"comparisons bit-equal, every one of the first design "
        f"({time.perf_counter() - t0:.1f} s)")

    # fault F2, fp8: the fused step (gol, jacobi and wave at M=64 under the
    # periodic and neumann0 contracts, S ∈ {1, 2}; gol and jacobi at
    # M=256, S=4), the resident tap sum (random weights) and the repack tap
    # sum (every SUM_SHAPES shape at M=64, T=8 at M=256) on float8_e4m3fn
    # and float8_e5m2 stores holding ±[440, 480] and NaN, each of the first
    # design and bit-equal to its plain version (NaN where it is NaN; e4m3fn
    # results above 464 are NaN, as XLA rounds)
    t0 = time.perf_counter()
    n_cmp, n_nan, T, g = 0, 0, 8, 1
    fp8_cases = [(M, rule, bcn, S) for rule in ("gol", "jacobi", "wave")
                 for bcn in ("periodic", "neumann0") for S in (1, 2)]
    fp8_cases += [(M_MAIN, rule, "periodic", S_MAIN) for rule in ("gol", "jacobi")]
    for dtype in FP8:
        for M_, rule, bcn, S in fp8_cases:
            C = 2 if rule == "wave" else 1
            cube = fp8_cube(rule, M_, C)
            store = ref.round_to(blockize_fields(cube, T, "hilbert") if C == 2
                                 else blockize(cube[0], T, "hilbert"), dtype)
            bc = bc_of(bcn)
            nbr = neighbor_table_device("hilbert", M_ // T,
                                        periodic=axes_periodic(bc), device=dev)
            bnd = boundary_face_table_device("hilbert", M_ // T, dev)
            w = uniform_weights(g, dev)
            what = f"fused {dtype} M={M_} {rule} {bcn} S={S}"
            check(K.fused_design(T, g, S, C, dtype) == "simple", what)
            got = stencil_on("simple", lambda: K.stencil_step_fused(
                store, w, nbr, bnd, g=g, S=S, rule=rule, bc=bc), what)
            want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule, bc=bc,
                                         bnd=bnd)
            check(got.dtype == dtype and same_bits(got, want), f"{what} != plain")
            n_nan += int(torch.isnan(want.float()).sum())
            n_cmp += 1
            del cube, store, got, want
        for M_ in (M, M_MAIN):
            cube = fp8_cube("jacobi", M_)[0]
            store = ref.round_to(blockize(cube, T, "hilbert"), dtype)
            nbr = neighbor_table_device("hilbert", M_ // T, device=dev)
            got = stencil_on("simple", lambda: K.stencil_sum_resident(
                store, w_rand, nbr, g=g), f"resident {dtype} M={M_}")
            check(got.dtype == torch.float32 and same_bits(
                got, ref.stencil_sum_resident_ref(store, w_rand, nbr)),
                f"resident {dtype} M={M_} != plain")
            n_cmp += 1
            for T_, g_ in SUM_SHAPES if M_ == M else ((T, g),):
                s_ = 2 * g_ + 1
                halo = ref.round_to(blockize_with_halo(cube, T_, g_, "hilbert"), dtype)
                w = torch.from_numpy(rng.normal(size=(s_, s_, s_)).astype(np.float32)).to(dev)
                what = f"blocks {dtype} M={M_} T={T_} g={g_}"
                check(K.blocks_design(T_, g_, dtype) == "simple", what)
                got = blocks_on("simple", lambda: K.stencil_sum_blocks(halo, w, g=g_), what)
                check(got.dtype == torch.float32
                      and same_bits(got, ref.stencil_sum_ref(halo, w)), f"{what} != plain")
                n_cmp += 1
            del cube, store, got
    sync()
    log(f"F2, fp8 stores at M={M} and M={M_MAIN}: {n_cmp} fused, resident and "
        f"repack comparisons bit-equal (NaN where the plain version has NaN: "
        f"{n_nan} fused sites), every one of the first design "
        f"({time.perf_counter() - t0:.1f} s)")

    # every instance of the Hopper stencil design, under each rule it is
    # built for and the four boundaries, at M=32 (random weights but for
    # gol, whose rule counts neighbours); and, on the first boundary's
    # inputs, the design forced with and without its overlap (the launch
    # picks one by occupancy), as the timings run it
    t0 = time.perf_counter()
    M_I, n_cmp = 32, 0
    inst = [(T, g, S, C) for T in (8, 16) for g in (1, 2) for S in (1, 2, 4, 8, 16)
            for C in (1, 2) if K.fused_design(T, g, S, C) == "sm90"]
    check(len(inst) == 20, f"{len(inst)} (T, g, S, C) instances of the Hopper design")
    for n_i, (T, g, S, C) in enumerate(inst):
        nb_i, s_ = (M_I // T) ** 3, 2 * g + 1
        for rule in ("wave",) if C == 2 else ("gol", "jacobi", "identity"):
            w = uniform_weights(g, dev) if rule == "gol" else torch.from_numpy(
                rng.normal(size=(s_, s_, s_)).astype(np.float32)).to(dev)
            for b_i, bcn in enumerate(BCS):
                kind = KINDS[(n_i + b_i) % len(KINDS)]
                cube = cube_for(rule, M_I, C)
                store = (blockize_fields(cube, T, kind) if C == 2
                         else blockize(cube[0], T, kind))
                bc = as_boundary(bc_of(bcn))
                nbr = neighbor_table_device(kind, M_I // T, periodic=axes_periodic(bc),
                                            device=dev)
                bnd = boundary_face_table_device(kind, M_I // T, dev)
                what = f"sm90 T={T} g={g} S={S} {rule} {bcn} {kind}"
                got = stencil_on(step_design(T, g, S, C, bc), lambda: K.stencil_step_fused(
                    store, w, nbr, bnd, g=g, S=S, rule=rule, bc=bc), what)
                want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule, bc=bc,
                                             bnd=bnd)
                check(torch.equal(got, want),
                      f"{what}: max |d| {(got - want).abs().max().item()}")
                n_cmp += 1
                for overlap in (True, False) if b_i == 0 else ():
                    forced = torch.full_like(got, float("nan"))
                    stencil_on("sm90", lambda: K._fused_on_card(
                        "sm90", store, w, nbr, None, forced, nb_i, g=g, S=S,
                        rule=rule, bc=bc, overlap=overlap),
                        f"{what} overlap={overlap}")
                    check(torch.equal(forced, want), f"{what} overlap={overlap} != plain")
                    n_cmp += 1
        if C == 1 and S == 1:  # the resident sum's own entry, both ways
            cube = cube_for("jacobi", M_I)[0]
            store = blockize(cube, T, "hilbert")
            nbr = neighbor_table_device("hilbert", M_I // T, device=dev)
            w = torch.from_numpy(rng.normal(size=(s_, s_, s_)).astype(np.float32)).to(dev)
            want = ref.stencil_sum_resident_ref(store, w, nbr)
            for overlap in (True, False):
                got = torch.full_like(store, float("nan"))
                stencil_on("sm90", lambda: K._resident_on_card(
                    "sm90", store, w, nbr, got, g=g, overlap=overlap),
                    f"resident sm90 T={T} g={g} overlap={overlap}")
                check(torch.equal(got, want),
                      f"resident sm90 T={T} g={g} overlap={overlap} != plain")
                n_cmp += 1
    sync()
    log(f"Hopper stencil design: {len(inst)} (T, g, S, C) instances, {n_cmp} "
        f"comparisons bit-equal at M={M_I} ({time.perf_counter() - t0:.1f} s)")

    # every instance of its group design (one thread block a 2x2x2 group
    # of blocks over a periodic cube), under each rule it is built for, on
    # every block curve, launched by the wrapper, with the block design
    # forced beside it: at M=32 (8 groups, so each thread block steps one)
    # and at M=128 (512 groups over the card's 132 thread blocks, 3 or 4
    # each, so the persistent loop brings the next window in and, at odd
    # S, swaps its buffers; where a third window fits, its streaming
    # branch forced too); then the wave cells' shape at M=256 (S=4) on
    # the Hilbert and row-major stores, both designs against the plain
    # version
    t0 = time.perf_counter()
    n_cmp = 0
    periodic = as_boundary("periodic")
    ginst = [(T, g, S, C) for T in (8, 16) for g in (1, 2) for S in (1, 2, 4, 8, 16)
             for C in (1, 2) if K.fused_design(T, g, S, C, cube=True) == "sm90_group"]
    check(len(ginst) == 8, f"{len(ginst)} (T, g, S, C) instances of the group design")
    for (T, g, S, C), M_G in itertools.product(ginst, (32, 128)):
        nb_i, s_ = (M_G // T) ** 3, 2 * g + 1
        for rule in ("wave",) if C == 2 else ("gol", "jacobi", "identity"):
            w = uniform_weights(g, dev) if rule == "gol" else torch.from_numpy(
                rng.normal(size=(s_, s_, s_)).astype(np.float32)).to(dev)
            for kind in KINDS:
                cube = cube_for(rule, M_G, C)
                store = (blockize_fields(cube, T, kind) if C == 2
                         else blockize(cube[0], T, kind))
                nbr = neighbor_table_device(kind, M_G // T, device=dev)
                what = f"sm90_group M={M_G} T={T} g={g} S={S} {rule} {kind}"
                got = stencil_on("sm90_group", lambda: K.stencil_step_fused(
                    store, w, nbr, g=g, S=S, rule=rule), what)
                want = ref.stencil_fused_ref(store, w, nbr, S=S, rule=rule)
                forced = torch.full_like(got, float("nan"))
                stencil_on("sm90", lambda: K._fused_on_card(
                    "sm90", store, w, nbr, None, forced, nb_i, g=g, S=S, rule=rule,
                    bc=periodic), f"{what}, the block design forced")
                check(torch.equal(got, want) and torch.equal(forced, want),
                      f"{what}: max |d| {(got - want).abs().max().item()}, the block "
                      f"design's {(forced - want).abs().max().item()}")
                n_cmp += 2
                if M_G == 128 and K.group_smem_bytes(
                        T, g, S, fields=C, windows=3) <= K.SMEM_LIMIT_BYTES:
                    # it prefetches: its streaming branch forced as well
                    streamed = torch.full_like(got, float("nan"))
                    stencil_on("sm90_group", lambda: K._fused_on_card(
                        "sm90_group", store, w, nbr, None, streamed, nb_i, g=g, S=S,
                        rule=rule, bc=periodic, overlap=False,
                        groups=group_table_device(nbr)), f"{what} streaming")
                    check(torch.equal(streamed, want), f"{what} streaming != plain")
                    n_cmp += 1
    w = uniform_weights(G_MAIN, dev)
    for kind in ("hilbert", "row_major"):
        store = blockize_fields(cube_for("wave", M_MAIN, 2), T_MAIN, kind)
        nbr = neighbor_table_device(kind, M_MAIN // T_MAIN, device=dev)
        what = f"sm90_group wave M={M_MAIN} S={S_MAIN} {kind}"
        got = stencil_on("sm90_group", lambda: K.stencil_step_fused(
            store, w, nbr, g=G_MAIN, S=S_MAIN, rule="wave"), what)
        want = ref.stencil_fused_ref(store, w, nbr, S=S_MAIN, rule="wave")
        forced = torch.full_like(got, float("nan"))
        stencil_on("sm90", lambda: K._fused_on_card(
            "sm90", store, w, nbr, None, forced, store.shape[1], g=G_MAIN, S=S_MAIN,
            rule="wave", bc=periodic), f"{what}, the block design forced")
        check(torch.equal(got, want) and torch.equal(forced, want),
              f"{what}: max |d| {(got - want).abs().max().item()}")
        n_cmp += 2
        del store, got, want, forced
    sync()
    log(f"group design: {len(ginst)} (T, g, S, C) instances, {n_cmp} comparisons "
        f"bit-equal at M=32, M=128 and the wave cells' M={M_MAIN} "
        f"({time.perf_counter() - t0:.1f} s)")

    # The fused kernel on extended stores: the core and shell blocks of a
    # 2×2×2 local mesh of M=64 shards, the shells filled by the
    # distributed path's own exchange and scatter (halo.fill_shells); its
    # table points at shell rows ≥ nb, its flags are masked by the shard's
    # mesh position, and it writes the core of a second extended store.
    t0 = time.perf_counter()
    n_cmp, T, g = 0, 8, 1
    nt = M // T
    nb = nt ** 3
    mesh_e = make_stencil_mesh((2, 2, 2), device=dev)
    nbr_e = extended_neighbor_table_device("hilbert", nt, dev)
    w = uniform_weights(g, dev)
    for rule in ("gol", "wave"):
        C = 2 if rule == "wave" else 1
        stores = [blockize_fields(cube_for(rule, M, C), T, "hilbert") if C == 2
                  else blockize(cube_for(rule, M)[0], T, "hilbert")
                  for _ in mesh_e.shards]
        for bcn in ("periodic", "neumann0", "mixed"):
            bc = bc_of(bcn)
            for S in (1, 2, 4):
                exts = [extended_store(st, nt) for st in stores]
                fill_shells(mesh_e, exts, kind="hilbert", M=M, h=S * g, bc=bc)
                for co, ext in zip(mesh_e.shards, exts):
                    bnd = shard_boundary_flags("hilbert", nt, co, mesh_e.shape,
                                               dev) if as_boundary(bc).clamped else None
                    spare = torch.zeros_like(ext)
                    got = stencil_on(K.fused_design(T, g, S, C),
                                     lambda: K.stencil_step_fused(
                                         ext, w, nbr_e, bnd, g=g, S=S, rule=rule,
                                         bc=bc, out=core_of(spare, nb)),
                                     f"fused on extended store {rule} {bcn} S={S}")
                    want = ref.stencil_fused_ref(ext, w, nbr_e, S=S, rule=rule,
                                                 bc=bc, bnd=bnd)
                    check(torch.equal(got, want),
                          f"fused on extended store {rule} {bcn} S={S} shard "
                          f"{co}: max |d| {(got - want).abs().max().item()}")
                    shell = spare[..., nb:, :, :, :]
                    check(not bool(shell.any()), "fused wrote outside the core")
                    n_cmp += 1
    sync()
    log(f"fused on extended stores at M={M} (2x2x2 shards): {n_cmp} "
        f"comparisons bit-equal ({time.perf_counter() - t0:.1f} s)")

    # gather_rows on the deep faces of the M=256, T=8 block store: the rows
    # covering each face, as the exchange's packs fetch them (line 64).
    t0 = time.perf_counter()
    cube_d = cube_for("jacobi", M_D)[0]
    n_cmp = 0

    def gather_check(src, rows, what):
        got = gather_rows(src, rows)
        check(torch.equal(got, ref.gather_rows_ref(src, rows))
              and torch.equal(got, torch.index_select(src, 0, rows)),
              f"gather_rows != plain: {what}")

    for kind in KINDS:
        src = blockize(cube_d, T_D, kind).reshape(-1, LINE)
        for h in (1, 2, 4):
            for face in FACES:
                gather_check(src, face_rows(kind, h, face)[1],
                             f"{kind} h={h} {face}")
                n_cmp += 1
    src = blockize(cube_d, T_D, "hilbert").reshape(-1, LINE)
    idx, rows = face_rows("hilbert", 4, "i0")
    for dtype in (torch.bfloat16, torch.int32):
        gather_check(src.to(dtype) if dtype != torch.int32
                     else (src * 1000).to(dtype), rows, f"{dtype} i0 h=4")
        n_cmp += 1
    stacked = torch.stack([src.reshape(-1), -src.reshape(-1)])
    got = kops.sfc_gather_take(stacked, idx, line=LINE)
    want = stacked[:, torch.from_numpy(idx.astype(np.int64)).to(dev)]
    check(torch.equal(got, want),
          "sfc_gather_take on a (2, n) store != data[..., idx]")
    n_cmp += 1
    sync()
    log(f"gather_rows vs plain at M={M_D}: {n_cmp} comparisons bit-equal "
        f"({time.perf_counter() - t0:.1f} s)")

    # flash_attention_fwd against its plain version: the prefill's shape
    # (the GQA-folded q, k, v of one smollm-360m layer at B=4, S=2048) under
    # each schedule, every instance of the Hopper design, the simple
    # design's cases, and one launch at S=32768; each case asserts which
    # design flash_design sent it to
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return ref.round_to(torch.randn(*shape, generator=gen, device=dev), dtype)

    def flash_err(got, want, what):
        """max |got - want|, after checking it is within the tolerance of
        got's dtype: 1e-5 in f32; in bf16, f16 and fp8 one unit in the last
        place at the plain value plus 1e-5 (bf16 as PR 14 states it)."""
        g, w = got.float(), want.float()
        d = (g - w).abs()
        if got.dtype == torch.float32:
            tol = FLASH_F32_TOL + FLASH_F32_TOL * w.abs()
        elif got.dtype == torch.bfloat16:
            tol = FLASH_BF16_ATOL + FLASH_BF16_RTOL * w.abs()
        else:
            fi = torch.finfo(got.dtype)
            tol = FLASH_BF16_ATOL + torch.exp2(torch.floor(torch.log2(
                w.abs().clamp_min(fi.tiny)))) * fi.eps
        check(got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(g).all()) and bool((d <= tol).all()),
              f"flash_attention_fwd != plain: {what}: max |d| {d.max().item()}")
        return d.max().item()

    def flash_on(design, q, k, v, **kw):
        """flash_attention_fwd, after checking that ``design`` runs it."""
        return one_launch_of(_build.FLASH_DESIGN_LAUNCHES, design,
                             lambda: flash_attention_fwd(q, k, v, **kw),
                             f"flash {tuple(q.shape)} {q.dtype} {kw}")

    lm_cfg = dataclasses.replace(lm_sizes.CONFIG, use_flash_kernel=True)
    B_P, S_P = lm_sizes.CHIP_PREFILL_BATCH, lm_sizes.CHIP_PREFILL_SEQ
    H, KVH, HD = lm_cfg.n_heads, lm_cfg.n_kv_heads, lm_cfg.hd
    fq, fk, fv = kops._fold_gqa(randn(B_P, H, S_P, HD, dtype=torch.bfloat16),
                                randn(B_P, KVH, S_P, HD, dtype=torch.bfloat16),
                                randn(B_P, KVH, S_P, HD, dtype=torch.bfloat16))
    flash_want = ref.flash_attention_ref(fq, fk, fv)
    by_sched, n_cmp, flash_main_err = {}, 0, 0.0
    for sched in FLASH_SCHEDULES:
        by_sched[sched] = flash_on("sm90", fq, fk, fv, causal=True,
                                   block_q=FLASH_BLOCK, block_k=FLASH_BLOCK,
                                   schedule=sched)
        err = flash_err(by_sched[sched], flash_want,
                        f"{tuple(fq.shape)} bf16 {sched}")
        flash_main_err = max(flash_main_err, err)
        log(f"flash {tuple(fq.shape)} bf16 causal {sched}: max |d| {err:.3g}")
        n_cmp += 1
    sched_diff = max((a.float() - b.float()).abs().max().item()
                     for a in by_sched.values() for b in by_sched.values())
    # the simple design: f32 on the JAX package's test shapes and others,
    # and its widest bf16 build
    cases = [((BH, Sq, Sk, D), causal, 16, 16, sched)
             for BH, Sq, Sk, D in ((2, 64, 64, 16), (1, 128, 128, 32), (2, 32, 128, 16))
             for causal in (True, False) for sched in FLASH_SCHEDULES]
    cases = [case + (torch.float32,) for case in cases]
    cases += [((3, 128, 64, 64), True, 32, 16, "hilbert", torch.float32),  # Sq > Sk
              ((3, 96, 96, 40), True, 32, 48, "morton", torch.float32),
              # D in (64, 128]: the DP=128 build, in both dtypes
              ((2, 64, 192, 96), True, 32, 64, "hilbert", torch.float32),
              ((2, 256, 256, 128), True, 64, 32, "morton", torch.float32),
              ((2, 256, 256, 128), True, 64, 32, "hilbert", torch.bfloat16)]
    # the blocks ops._pick_block gives from 128 at S = 12, 24 and 100, which
    # are not multiples of 16, and a head dim of 12 (padded to 16)
    f1_cases = [((3, S_, S_, 64), causal, kops._pick_block(S_, FLASH_BLOCK),
                 kops._pick_block(S_, FLASH_BLOCK), "morton", dt)
                for S_ in (12, 24, 100) for causal in (True, False)
                for dt in (torch.float32, torch.bfloat16)]
    f1_cases.append(((3, 24, 24, 12), True, 24, 24, "hilbert", torch.float32))
    check({flash_design(c[5], c[0][3], c[2], c[3]) for c in f1_cases} == {"simple"}
          and {c[2] for c in f1_cases} == {12, 24, 100},
          "the F1 cases take the simple design at blocks 12, 24 and 100")
    cases += f1_cases
    # F1's head dims above 128 (gemma3-1b's 256; 160 padded to the same
    # DP=256 build): two threads a q row, keys staged 64 at a time
    wide_cases = [((2, 256, 256, D), causal, b, b, "morton", dt)
                  for D in (160, 256) for dt in (torch.float32, torch.bfloat16)
                  for causal in (True, False) for b in (64, 128)]
    check({flash_design(c[5], c[0][3], c[2], c[3]) for c in wide_cases} == {"simple"},
          "head dims above 128 take the simple design")
    cases += wide_cases
    # F3: f16 and both fp8 dtypes at the prefill's shape (BH=60, S=2048,
    # D=64), and at D=40 (padded to 48), Sq > Sk, non-causal; F1 up to
    # D=1024: D ∈ {320, 512, 1024} at BH=16, S=2048 in bf16 and f32 (NS =
    # 4 and 8 threads a q row, keys staged 32 and 16 at a time, a q block
    # over thread blocks of 256 threads), and small
    # ones with other blocks and schedules
    f3_cases = [((60, 2048, 2048, 64), True, FLASH_BLOCK, FLASH_BLOCK, "morton", dt)
                for dt in (torch.float16,) + FP8]
    f3_cases += [((2, 256, 256, 40), True, 64, 64, "hilbert", FP8[0]),
                 ((2, 128, 64, 96), True, 32, 16, "morton", torch.float16),
                 ((2, 256, 384, 64), False, 64, 128, "row_major", FP8[1])]
    f1_wide = [((16, 2048, 2048, D), True, FLASH_BLOCK, FLASH_BLOCK, "morton", dt)
               for D in (320, 512, 1024) for dt in (torch.bfloat16, torch.float32)]
    f1_wide += [((2, 256, 256, 1024), False, 64, 64, "hilbert", torch.bfloat16),
                ((2, 128, 192, 512), True, 16, 32, "row_major", torch.float32),
                ((2, 256, 256, 600), True, 128, 64, "morton", torch.float16),
                # q blocks of 100 rows over thread blocks of 64 (DP=512)
                # and 32 (DP=1024) rows: the last one's rows past 100 idle
                ((2, 200, 200, 512), True, 100, 100, "hilbert", torch.float32),
                ((2, 200, 200, 1000), True, 100, 100, "morton", torch.bfloat16)]
    check({flash_design(c[5], c[0][3], c[2], c[3]) for c in f3_cases + f1_wide}
          == {"simple"}, "f16, fp8 and head dims above 256 take the simple design")
    cases += f3_cases + f1_wide
    # F1 above 1024: the wide instance (16 q rows x 16 keys a thread block,
    # the head dim in slices of 256, the accumulator in an f32 workspace);
    # F4: more folded heads than a grid has rows (65,535), launched in
    # chunks by both designs
    f1_xwide = [((4, 256, 256, D), causal, 64, 64, "hilbert", dt)
                for D in (1152, 2048, 4096) for dt in (torch.float32, torch.bfloat16)
                for causal in (True, False)]
    f1_xwide += [((2, 128, 192, 1100), True, 32, 64, "row_major", torch.float16),
                 ((2, 128, 128, 2048), False, 128, 128, "morton", FP8[0])]
    f4_cases = [((65540, 64, 64, 64), True, 64, 64, "morton", dt)
                for dt in (torch.bfloat16, torch.float32)]
    check({flash_design(c[5], c[0][3], c[2], c[3]) for c in f1_xwide} == {"simple"}
          and [flash_design(c[5], 64, 64, 64) for c in f4_cases] == ["sm90", "simple"],
          "head dims above 1024 take the simple design; BH=65540 both designs")
    cases += f1_xwide + f4_cases
    # the Hopper design: every (D, block_q, block_k) instance, causal; rows
    # with no key in an unvisited q block (384 x 256, 128-blocks) and in a
    # visited one (384 x 320, 128 x 64: rows 0..63 of q block 0); Sq < Sk;
    # non-causal; each under the three schedules
    sm90 = [((2, 256, 256, D), True, bq, bk)
            for D in (64, 128) for bq in (64, 128) for bk in (64, 128)]
    sm90 += [((2, 384, 256, 64), True, 128, 128), ((2, 384, 320, 64), True, 128, 64),
             ((2, 256, 512, 64), True, 128, 128), ((2, 256, 256, 64), False, 128, 128),
             ((2, 256, 384, 128), False, 64, 128)]
    cases += [case + (sched, torch.bfloat16) for case in sm90
              for sched in FLASH_SCHEDULES]
    n_sm90 = 0
    for (BH, Sq, Sk, D), causal, bq, bk, sched, dt in cases:
        q, k, v = randn(BH, Sq, D, dtype=dt), randn(BH, Sk, D, dtype=dt), randn(BH, Sk, D, dtype=dt)
        design = flash_design(dt, D, bq, bk)
        got = flash_on(design, q, k, v, causal=causal, block_q=bq, block_k=bk,
                       schedule=sched)
        flash_err(got, ref.flash_attention_ref(q, k, v, causal=causal),
                  f"{(BH, Sq, Sk, D)} {dt} causal={causal} {bq}x{bk} {sched} {design}")
        if Sq > Sk and causal:
            check(not bool(got[:, :Sq - Sk].any()), "rows with no key are not 0")
        n_cmp += 1
        n_sm90 += design == "sm90"
    check(n_sm90 == 3 * len(sm90) + 1, f"{n_sm90} cases ran the Hopper design")
    L_S = lm_sizes.CHIP_LONG_SEQ
    lq, lk, lv = (randn(H, L_S, HD, dtype=torch.bfloat16) for _ in range(3))
    tail = flash_on("sm90", lq, lk, lv, causal=True, block_q=FLASH_BLOCK,
                    block_k=FLASH_BLOCK, schedule=lm_cfg.flash_schedule)[:, -256:]
    long_err = flash_err(tail, ref.flash_attention_ref(lq[:, -256:], lk, lv),
                         f"S={L_S} BH={H}, last 256 rows")
    n_cmp += 1
    sync()
    log(f"flash_attention_fwd vs plain: {n_cmp} comparisons within tolerance "
        f"({n_sm90 + 4} of the Hopper design); largest difference between "
        f"schedules at {tuple(fq.shape)}: {sched_diff:.3g}; S={L_S} BH={H}: "
        f"last 256 rows max |d| {long_err:.3g} ({time.perf_counter() - t0:.1f} s)")
    del tail

    # ----------------------------------------- main paths, launches counted
    main_launches = {name: 0 for name in K.LAUNCHES}

    def counted(fn):
        """fn() with the launch counts set to 0 just before and read just
        after; every fused, resident and repack launch must be of a Hopper
        design (the block or the group design)."""
        K.reset_launches()
        out = fn()
        sync()
        counts = dict(K.LAUNCHES)
        by_design = dict(_build.STENCIL_DESIGN_LAUNCHES)
        stencil = counts["stencil_step_fused"] + counts["stencil_sum_resident"]
        check(by_design["simple"] == 0
              and by_design["sm90"] + by_design["sm90_group"] == stencil,
              f"fused and resident launches by design {by_design}, want all "
              f"{stencil} sm90 or sm90_group")
        by_blocks = dict(_build.BLOCKS_DESIGN_LAUNCHES)
        check(by_blocks == {"sm90": counts["stencil_sum_blocks"], "simple": 0},
              f"repack launches by design {by_blocks}, want all "
              f"{counts['stencil_sum_blocks']} sm90")
        for name, n in counts.items():
            main_launches[name] += n
        return out, counts

    t0 = time.perf_counter()
    apps = {}
    for spec in CHIP_ORDERINGS:
        kind = spec.name
        app = Gol3d(dataclasses.replace(CHIP_MAIN, ordering=spec))
        want = app.reference_run(K_MAIN)
        _, counts = counted(lambda: app.run_resident(K_MAIN))
        got = app.cube
        check(counts["stencil_step_fused"] == -(-K_MAIN // S_MAIN)
              == _build.STENCIL_DESIGN_LAUNCHES["sm90_group"],
              f"{kind}: {counts} fused launches for K={K_MAIN}, S={S_MAIN}, by "
              f"design {_build.STENCIL_DESIGN_LAUNCHES}, want all sm90_group")
        check(got.shape == (M_MAIN,) * 3 and bool(torch.isfinite(got).all()),
              f"{kind}: result not finite or misshapen")
        check(torch.equal(got, want), f"{kind}: run_resident != reference_run")
        apps[kind] = app
        log(f"main gol3d {kind}: M={M_MAIN} T={T_MAIN} S={S_MAIN} K={K_MAIN} "
            f"launches {counts['stencil_step_fused']}, equal to reference_run, "
            f"live cells {int(got.sum().item())}")

    fields = torch.from_numpy(
        np.random.default_rng(2).normal(size=(2,) + (M_MAIN,) * 3)
        .astype(np.float32)).to(dev)
    wave = ResidentPipeline(M=M_MAIN, T=T_MAIN, g=G_MAIN, kind="hilbert", S=2,
                            rule="wave", bc="neumann0", device=dev)
    got, counts = counted(lambda: wave.run(fields, 8))
    wave_cube = got  # the ROI slice serves its store
    want = fields
    for _ in range(8):
        want = ref.fields_step_ref(want, uniform_weights(G_MAIN, dev), G_MAIN,
                                   rule="wave", bc="neumann0")
    check(counts["stencil_step_fused"] == 4, f"wave launches {counts}")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
          "wave pipeline != 8 steps of fields_step_ref")
    log(f"main wave: M={M_MAIN} C=2 S=2 neumann0 K=8 launches "
        f"{counts['stencil_step_fused']}, equal to fields_step_ref")

    rep_app = Gol3d(CHIP_REPACK)
    want = rep_app.reference_run(CHIP_REPACK_STEPS)
    _, counts = counted(lambda: rep_app.run(CHIP_REPACK_STEPS))
    check(counts["stencil_sum_blocks"] == CHIP_REPACK_STEPS,
          f"repack launches {counts}")
    check(_build.BLOCKS_DESIGN_LAUNCHES["sm90"] == CHIP_REPACK_STEPS,
          f"repack launches by design {_build.BLOCKS_DESIGN_LAUNCHES}")
    check(torch.equal(rep_app.cube, want), "repack run != reference_run")
    log(f"main repack: M={CHIP_REPACK.M} {rep_app.block_kind} "
        f"K={CHIP_REPACK_STEPS} launches {counts['stencil_sum_blocks']}, all of "
        f"the Hopper design, equal to reference_run")

    cube = apps["hilbert"].cube.contiguous()
    w1 = uniform_weights(G_MAIN, dev)
    store = blockize(cube, T_MAIN, "hilbert")
    nbr_h = neighbor_table_device("hilbert", M_MAIN // T_MAIN, device=dev)
    groups_h = group_table_device(nbr_h)
    acc, counts = counted(lambda: K.stencil_sum_resident(store, w1, nbr_h,
                                                         g=G_MAIN))
    check(counts["stencil_sum_resident"] == 1, f"resident launches {counts}")
    check(torch.equal(acc, ref.stencil_sum_resident_ref(store, w1, nbr_h)),
          "resident sum != plain at M=256")
    halo_main = blockize_with_halo(cube, T_MAIN, G_MAIN, "hilbert")
    check(torch.equal(acc, K.stencil_sum_blocks(halo_main, w1, g=G_MAIN)),
          "resident sum != repack sum at M=256")

    # the distributed path: Gol3d.run_distributed(mesh, 16) per mesh and
    # ordering, at global M=256 (S=4: four exchange rounds)
    K_D, S_D = CHIP_DISTRIBUTED_STEPS, CHIP_DISTRIBUTED.substeps
    rounds = -(-K_D // S_D)
    meshes = {shape: make_stencil_mesh(shape, device=dev) for shape in CHIP_MESHES}
    for shape, mesh in meshes.items():
        n_sh = mesh.size
        for spec in CHIP_ORDERINGS:
            app = Gol3d(dataclasses.replace(CHIP_DISTRIBUTED, ordering=spec))
            want = app.reference_run(K_D)
            _, counts = counted(lambda: app.run_distributed(mesh, K_D))
            got = app.cube
            tag = f"distributed {'x'.join(map(str, shape))} {spec.name}"
            check(counts["stencil_step_fused"] == rounds * n_sh,
                  f"{tag}: {counts} fused launches for K={K_D}, S={S_D}")
            check(counts["gather_rows"] == rounds * n_sh * PACKS_PER_SHARD,
                  f"{tag}: {counts} gather_rows launches")
            check(got.shape == (M_D,) * 3 and bool(torch.isfinite(got).all()),
                  f"{tag}: result not finite or misshapen")
            check(torch.equal(got, want), f"{tag}: run_distributed != reference_run")
            log(f"main {tag}: M={M_D} local {M_D // shape[0]} T={T_D} S={S_D} "
                f"K={K_D} launches fused {counts['stencil_step_fused']} "
                f"gather {counts['gather_rows']}, equal to reference_run, "
                f"live cells {int(got.sum().item())}")
    wmesh = meshes[(2, 2, 2)]
    wbc = mixed(k="neumann0")
    wpipe = DistributedPipeline(mesh=wmesh, spec=CHIP_DISTRIBUTED.ordering,
                                M=M_D // 2, T=T_D, g=G_MAIN, S=2, rule="wave",
                                bc=wbc)
    got, counts = counted(lambda: wpipe.run_cube(fields, 8))
    want = fields
    for _ in range(8):
        want = ref.fields_step_ref(want, uniform_weights(G_MAIN, dev), G_MAIN,
                                   rule="wave", bc=wbc)
    check(counts["stencil_step_fused"] == 4 * wmesh.size
          and counts["gather_rows"] == 4 * wmesh.size * PACKS_PER_SHARD,
          f"distributed wave launches {counts}")
    check(bool(torch.isfinite(got).all()) and torch.equal(got, want),
          "distributed wave != 8 steps of fields_step_ref")
    log(f"main distributed wave: 2x2x2 local {M_D // 2} C=2 S=2 "
        f"mixed(k=neumann0) K=8 launches fused {counts['stencil_step_fused']} "
        f"gather {counts['gather_rows']}, equal to fields_step_ref")

    # The slice: the checkpointed main path (CHIP_MAIN: M=256, Hilbert, T=8,
    # S=4, g=1; K=16, a checkpoint every CKPT_INTERVAL steps, 64 MiB of f32
    # state each) under CheckpointedRun, and its fault matrix, in a
    # temporary directory removed at the end:
    # 1. uninterrupted, equal to Gol3d.run_resident(16) from the same state
    #    (the faults CLI's initial state), one fused launch per S-deep chunk;
    # 2. killed at step 6 (raise), resumed onto Morton, T=16, S=2: equal to 1;
    # 3. the newest checkpoint bit-flipped: resume quarantines it, restores
    #    the one before and ends equal to 1;
    # 4. NaN poisoned at step 5 (jacobi): RunHealthError at step 8 with
    #    last_good_step 4, nothing checkpointed past 4;
    # 5. the faults CLI killed by os._exit (exit 17), then resumed by a
    #    second process to the crc of 1;
    # 6. the elastic CLI: eight M=128 shards on a local 2×2×2 mesh killed
    #    at step 6, resumed on one M=256 shard (Morton, T=4, S=1), bit-exact
    #    against an uninterrupted resident run; its distributed half runs
    #    gather_rows.
    def fused_launches(pipe, chunks):
        """The fused launches ``pipe.run_fn`` makes over these chunks."""
        n = 0
        for k in chunks:
            full, rem = divmod(k, pipe.S)
            n += full + (1 if rem and pipe._valid_S(rem) else rem)
        return n

    def raised(fn, exc):
        """The exception of type ``exc`` that fn() raises (fn must raise)."""
        try:
            fn()
        except exc as e:
            return e
        raise RuntimeError(f"{exc.__name__} was not raised")

    def cli_launches(text, prefix):
        line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
        return json.loads(line[len(prefix):])

    t1 = time.perf_counter()
    state0 = initial_state("gol", M_MAIN, seed=0)
    ck_app = Gol3d(CHIP_MAIN)
    ck_app.state_path = apply_ordering(torch.from_numpy(state0).to(dev),
                                       CHIP_MAIN.ordering)
    ck_app.run_resident(K_C)
    ck_want = ck_app.cube.cpu().numpy()
    ck_pipe = ck_app.resident_pipeline()
    chunks = [IV] * (K_C // IV)
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        d1, d2 = os.path.join(work, "run1"), os.path.join(work, "run2")
        out1, counts = counted(lambda: CheckpointedRun(ck_pipe, d1, interval=IV)
                               .run(state0, K_C))
        check(counts["stencil_step_fused"] == fused_launches(ck_pipe, chunks),
              f"checkpointed run: {counts} fused launches for chunks {chunks}")
        check(out1.flags.c_contiguous and np.array_equal(out1, ck_want),
              "checkpointed run != Gol3d.run_resident")
        check(CK.valid_steps(d1) == list(range(0, K_C + 1, IV)),
              f"checkpoints {CK.valid_steps(d1)}")
        crc1 = state_crc(out1)
        shutil.rmtree(d1)
        log(f"slice 1, checkpointed: M={M_MAIN} {CHIP_MAIN.ordering.name} "
            f"T={T_MAIN} S={S_MAIN} K={K_C} interval {IV}: launches fused "
            f"{counts['stencil_step_fused']}, equal to Gol3d.run_resident, "
            f"crc {crc1:#010x}")

        _, counts = counted(lambda: raised(lambda: CheckpointedRun(
            ck_pipe, d2, interval=IV, hooks=FaultPlan(
                kill_at_step=6, kill_mode="raise").hooks()).run(state0, K_C),
            SimulatedCrash))
        check(CK.latest_step(d2) == 4 and counts["stencil_step_fused"]
              == fused_launches(ck_pipe, [4, 2]), f"killed run: {counts}")
        pipe2 = ResidentPipeline(M=M_MAIN, T=16, g=G_MAIN, kind="morton", S=2,
                                 device=dev)
        out2, counts = counted(lambda: CheckpointedRun(pipe2, d2, interval=IV)
                               .run(state0, K_C))
        check(counts["stencil_step_fused"] == fused_launches(pipe2, chunks[1:]),
              f"resumed run: {counts}")
        check(np.array_equal(out2, out1), "resume onto morton T=16 S=2 != run 1")
        log(f"slice 2, killed at 6 (newest checkpoint 4), resumed onto morton "
            f"T=16 S=2: launches fused {counts['stencil_step_fused']}, equal "
            f"to run 1")

        bitflip_chunk(d2, K_C)
        out3, counts = counted(lambda: CheckpointedRun(ck_pipe, d2, interval=IV)
                               .run(state0, K_C))
        check(os.path.isdir(os.path.join(d2, f".corrupt_step_{K_C:08d}"))
              and CK.valid_steps(d2) == list(range(0, K_C + 1, IV))
              and counts["stencil_step_fused"] == fused_launches(ck_pipe, [IV]),
              f"corrupt-chunk fallback: {CK.valid_steps(d2)}, {counts}")
        check(np.array_equal(out3, out1), "resume past a corrupt chunk != run 1")
        shutil.rmtree(d2)
        log(f"slice 3, newest checkpoint bit-flipped: quarantined, step "
            f"{K_C - IV} restored, launches fused "
            f"{counts['stencil_step_fused']}, equal to run 1")

        d4 = os.path.join(work, "run4")
        j_pipe = ResidentPipeline(M=M_MAIN, T=T_MAIN, g=G_MAIN, kind="hilbert",
                                  S=S_MAIN, rule="jacobi", device=dev)
        err, counts = counted(lambda: raised(lambda: CheckpointedRun(
            j_pipe, d4, interval=IV, hooks=FaultPlan(poison_at_step=5).hooks())
            .run(initial_state("jacobi", M_MAIN, seed=0), K_C), RunHealthError))
        check(err.step == 8 and err.last_good_step == 4 and "NaN" in err.reason
              and CK.latest_step(d4) == 4, f"poison guard: {err}")
        shutil.rmtree(d4)
        log(f"slice 4, NaN poisoned at 5 (jacobi): RunHealthError at step "
            f"{err.step}, last good step {err.last_good_step}; launches fused "
            f"{counts['stencil_step_fused']}")

        # the CLIs, started while the kernels' checks ran
        r, latest, r2 = background["faults"]()
        check(r.returncode == KILL_EXIT and latest == 4,
              f"faults CLI kill: exit {r.returncode}, newest checkpoint {latest}\n"
              f"{r.stdout}\n{r.stderr[-3000:]}")
        done = [ln for ln in r2.stdout.splitlines() if ln.startswith("FAULTS_DONE")]
        sub = cli_launches(r2.stdout, "FAULTS_LAUNCHES ") if r2.returncode == 0 else {}
        check(r2.returncode == 0 and done == [f"FAULTS_DONE step={K_C} crc={crc1:#010x}"]
              and sub.get("stencil_step_fused") == fused_launches(ck_pipe, chunks[1:]),
              f"faults CLI resume: exit {r2.returncode}\n{r2.stdout}\n{r2.stderr[-3000:]}")
        log(f"slice 5, faults CLI: killed with exit {r.returncode}, resumed by a "
            f"second process: {done[0]} (run 1's crc), its launches {sub}")

        r = background["elastic"]()
        sub = cli_launches(r.stdout, "[elastic] launches ") if r.returncode == 0 else {}
        check(r.returncode == 0 and "bit-exact vs uninterrupted run" in r.stdout
              and sub.get("gather_rows", 0) > 0 and sub.get("stencil_step_fused", 0) > 0,
              f"elastic CLI: exit {r.returncode}\n{r.stdout}\n{r.stderr[-3000:]}")
        log(f"slice 6, elastic CLI 2x2x2 (local {M_MAIN // 2}) -> 1x1x1: "
            + "; ".join(ln for ln in r.stdout.splitlines() if ln.startswith("[elastic]")))
        shutil.rmtree(cli_dir, ignore_errors=True)

        # Where a checkpoint's time goes, on the host's clock (each part alone,
        # median of 3): the checkpointed run against the plain run in turns
        # (plain, checkpointed, checkpointed, plain), then each part of one
        # checkpoint and of one restore of this state.
        cube0 = torch.from_numpy(state0).to(dev)

        def wall(fn):
            sync()
            t_ = time.perf_counter()
            fn()
            sync()
            return 1e3 * (time.perf_counter() - t_)

        def ckpt_run():
            d_ = tempfile.mkdtemp(dir=work)
            try:
                CheckpointedRun(ck_pipe, d_, interval=IV).run(state0, K_C)
            finally:
                shutil.rmtree(d_)

        plain_run = lambda: ck_pipe.run(cube0, K_C)  # noqa: E731
        plain_run()
        walls = {"plain": [], "checkpointed": []}
        for name in ("plain", "checkpointed", "checkpointed", "plain"):
            walls[name].append(wall(plain_run if name == "plain" else ckpt_run))
        w_plain = statistics.mean(walls["plain"])
        w_ckpt = statistics.mean(walls["checkpointed"])
        n_ckpt = K_C // IV + 1  # step 0 too
        per_ckpt = (w_ckpt - w_plain) / n_ckpt
        step_ms = w_plain / K_C

        def part(fn, n=3):
            return statistics.median(wall(fn) for _ in range(n))

        st_dev = ck_pipe.to_blocks(cube0)
        host = {}
        t_unblock = part(lambda: host.update(cube=ck_pipe.to_cube(st_dev)))
        t_d2h = part(lambda: host.update(arr=host["cube"].cpu().numpy()))
        arr = np.ascontiguousarray(host["arr"])
        t_crc = [part(lambda: CK.crc32(arr)) for _ in range(2)]
        t_guard = part(lambda: health_check("gol", arr, [0.0, 1.0]))
        npz = os.path.join(work, "part.npz")

        def write_npz():
            with open(npz, "wb") as f:
                np.savez(f, state=arr)
                f.flush()
                host["fd"] = os.dup(f.fileno())

        def fsync():
            os.fsync(host["fd"])
            os.close(host["fd"])

        t_write, t_fsync = [], []
        for _ in range(3):
            t_write.append(wall(write_npz))
            t_fsync.append(wall(fsync))
        t_write, t_fsync = statistics.median(t_write), statistics.median(t_fsync)
        d_s = os.path.join(work, "save")
        t_save = part(lambda: CK.save(d_s, 1, {"state": arr}, meta={"step": 1}))
        t_read = part(lambda: host.update(back=np.load(npz)["state"]))
        t_verify = part(lambda: CK.crc32(host["back"]))
        t_blockize = part(lambda: ck_pipe.to_blocks(torch.from_numpy(host["back"]).to(dev)))
        t_restore = part(lambda: CK.restore(d_s))
        parts = (t_unblock + t_d2h + sum(t_crc) + t_guard + t_write + t_fsync)
        model = checkpoint_traffic_fraction(M_MAIN, T_MAIN, G_MAIN, IV, S=S_MAIN)
        share = per_ckpt / (per_ckpt + IV * step_ms)
        log(f"checkpointed main path: {w_ckpt / K_C:.4f} ms per timestep with a "
            f"checkpoint every {IV} (readings "
            f"{', '.join(f'{t:.1f}' for t in walls['checkpointed'])} ms per run), "
            f"plain run_resident {step_ms:.4f} (readings "
            f"{', '.join(f'{t:.1f}' for t in walls['plain'])} ms per run); "
            f"{n_ckpt} checkpoints of {arr.nbytes / 2 ** 20:.0f} MiB, "
            f"{per_ckpt:.1f} ms each")
        log(f"one checkpoint, each part alone: unblockize on the device "
            f"{t_unblock:.2f} ms, device->host copy {t_d2h:.2f} ms, crc32 "
            f"{t_crc[0]:.2f} + {t_crc[1]:.2f} ms, health guard {t_guard:.2f} ms, "
            f"npz write {t_write:.2f} ms, fsync {t_fsync:.2f} ms (sum "
            f"{parts:.1f} ms; ckpt.save whole {t_save:.1f} ms)")
        log(f"one restore, each part alone: npz read (page cache) {t_read:.2f} "
            f"ms, crc verify {t_verify:.2f} ms, host->device and blockize "
            f"{t_blockize:.2f} ms (ckpt.restore whole {t_restore:.1f} ms)")
        log(f"measured checkpoint share of an interval's wall {100 * share:.2f}% "
            f"(of the whole checkpointed run {100 * (1 - w_plain / w_ckpt):.2f}%) "
            f"beside the byte model's checkpoint_traffic_fraction({M_MAIN}, "
            f"{T_MAIN}, {G_MAIN}, {IV}, S={S_MAIN}) = {model:.4f}; the "
            f"checkpoint would be half the wall at an interval of "
            f"{per_ckpt / step_ms:.0f} steps")
        slice_row = dict(ckpt_ms_per_step=w_ckpt / K_C, plain_ms_per_step=step_ms,
                         ckpt_ms=per_ckpt, unblockize_ms=t_unblock, d2h_ms=t_d2h,
                         crc32_ms=t_crc, guard_ms=t_guard, npz_write_ms=t_write,
                         fsync_ms=t_fsync, save_ms=t_save, restore_read_ms=t_read,
                         restore_crc_ms=t_verify, restore_blockize_ms=t_blockize,
                         restore_ms=t_restore, measured_share=share,
                         model_share=model, half_wall_interval=per_ckpt / step_ms)
        del st_dev, host, arr, cube0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    sync()
    log(f"slice: checkpointed and elastic runs ({time.perf_counter() - t1:.1f} s)")

    # The slice of this round: the ROI-query service (serve/roi.py,
    # serve/service.py) over the store the card computed. CHIP_ROI
    # (= CHIP_MAIN: M=256, T=8, S=4, Hilbert) runs 16 steps from the faults
    # CLI's initial state (counted: 4 fused launches of the Hopper design);
    # the result, unblockized on the card, is blockized along each ordering,
    # copied to the host and served. Host clock throughout: the service is
    # host code and launches no kernel.
    t1 = time.perf_counter()
    M_Q, T_Q = CHIP_ROI.M, CHIP_ROI.block_T

    def host_ms(fn, n=3):
        """(median ms of n host-clock readings of fn(), ending in a
        synchronize; fn's last result)."""
        times = []
        for _ in range(n):
            sync()
            t_ = time.perf_counter()
            res_ = fn()
            sync()
            times.append(1e3 * (time.perf_counter() - t_))
        return statistics.median(times), res_

    def box_of(roi):
        return tuple(slice(l_, h_) for l_, h_ in zip(roi.lo, roi.hi))

    def served_exactly(r, want):
        """The payload equals ``want`` wherever it was delivered, and its
        NaN footprint is exactly the missing ranges' blocks (C=1 aligned
        boxes: a missing block lies whole in the box; gol has no NaN)."""
        miss = torch.isnan(r.payload)
        n_miss = sum(b - a for a, b in r.missing_ranges) * T_Q ** 3
        return torch.equal(r.payload[~miss], want[~miss]) and int(miss.sum()) == n_miss

    roi_pipe = ResidentPipeline(M=M_Q, T=T_Q, g=CHIP_ROI.g,
                                kind=CHIP_ROI.ordering.name, S=CHIP_ROI.substeps,
                                device=dev)
    roi_state = torch.from_numpy(initial_state("gol", M_Q, seed=0)).to(dev)
    roi_cube, counts = counted(lambda: roi_pipe.run(roi_state, CHIP_ROI_STEPS))
    check(counts["stencil_step_fused"] == -(-CHIP_ROI_STEPS // CHIP_ROI.substeps),
          f"ROI snapshot: {counts} fused launches")
    dense = roi_cube.cpu()
    check(np.array_equal(dense.numpy(), ck_want),
          "ROI snapshot != Gol3d.run_resident from the same state")
    log(f"ROI slice, snapshot: {CHIP_ROI.ordering.name} M={M_Q} T={T_Q} "
        f"S={CHIP_ROI.substeps} K={CHIP_ROI_STEPS}: launches fused "
        f"{counts['stencil_step_fused']} (all of the Hopper design), equal to "
        f"Gol3d.run_resident; live cells {int(dense.sum().item())}")
    suite = roi_suite(M_Q)
    roi_row = {"snapshot_fused_launches": counts["stencil_step_fused"]}
    hosts = {}
    for kind in KINDS:
        st_k = blockize(roi_cube, T_Q, kind)
        lay = StoreLayout(M=M_Q, T=T_Q, kind=kind)
        t_copy, host_st = host_ms(lambda: st_k.cpu())
        make = lambda: StencilQueryService(  # noqa: E731
            store=host_st, layout=lay, cache_blocks=CHIP_ROI_CACHE_BLOCKS,
            deadline_s=CHIP_ROI_DEADLINE_S)
        t_manifest, svc = host_ms(make)
        hosts[kind] = host_st
        row_k = {"d2h_ms": t_copy, "manifest_ms": t_manifest}
        log(f"ROI {kind}: device->host copy of the {host_st.nbytes / 2 ** 20:.0f} "
            f"MiB store {t_copy:.2f} ms, manifest of {lay.nb} crc32s "
            f"{t_manifest:.2f} ms (host clock, median of 3)")
        for name, roi in suite:
            model = roi_model(lay, roi)
            want = dense[box_of(roi)]
            cold = []
            for _ in range(CHIP_ROI_REPS):
                fresh = make()
                t_ = time.perf_counter()
                r = fresh.query(roi)
                cold.append(1e3 * (time.perf_counter() - t_))
                check(r.status == "ok" and torch.equal(r.payload, want)
                      and len(r.ranges) == model["ranges"]
                      and r.cache_hits == 0
                      and r.cache_misses == model["blocks_touched"]
                      and r.fetch_calls == model["ranges"],
                      f"ROI {kind} {name} cold: {r.status} {len(r.ranges)} ranges "
                      f"{r.cache_hits} hits {r.cache_misses} misses "
                      f"{r.fetch_calls} fetches, model {model}")
            cold_r = r
            svc.query(roi)  # fills the cache
            warm = []
            for _ in range(CHIP_ROI_REPS):
                t_ = time.perf_counter()
                r = svc.query(roi)
                warm.append(1e3 * (time.perf_counter() - t_))
                check(r.status == "ok" and torch.equal(r.payload, want)
                      and r.cache_hits == model["blocks_touched"]
                      and r.fetch_calls == 0,
                      f"ROI {kind} {name} warm: {r.status} {r.cache_hits} hits "
                      f"{r.fetch_calls} fetches")
            row_k[name] = dict(model, cold_ms=statistics.median(cold),
                               warm_ms=statistics.median(warm),
                               fetch_calls=cold_r.fetch_calls,
                               cold_misses=cold_r.cache_misses,
                               warm_hits=r.cache_hits)
            log(f"ROI {kind} {name} {roi.lo}->{roi.hi}: {model['ranges']} ranges, "
                f"{model['blocks_touched']} blocks, {model['bytes_read']} bytes "
                f"read, utilization {model['utilization']:.4f}; cold "
                f"{statistics.median(cold):.2f} ms (readings "
                f"{', '.join(f'{t:.1f}' for t in cold)}; {cold_r.fetch_calls} "
                f"fetches, {cold_r.cache_misses} misses), warm "
                f"{statistics.median(warm):.2f} ms (readings "
                f"{', '.join(f'{t:.1f}' for t in warm)}; {r.cache_hits} hits, "
                f"0 fetches); payloads bit-equal to the dense slice")
        roi_row[kind] = row_k
        del st_k, svc
    for name, _ in suite:
        check(roi_row["hilbert"][name]["ranges"] < roi_row["row_major"][name]["ranges"],
              f"ROI {name}: Hilbert {roi_row['hilbert'][name]['ranges']} ranges, "
              f"row-major {roi_row['row_major'][name]['ranges']}")
    log("ROI ranges by ordering: " + "; ".join(
        f"{name} " + ", ".join(f"{k} {roi_row[k][name]['ranges']}" for k in KINDS)
        for name, _ in suite) + " (Hilbert below row-major on every ROI)")

    # the wave phase's C=2 store (Hilbert): one query, both fields
    wlay = StoreLayout(M=M_Q, T=T_Q, kind="hilbert", channels=2)
    wsvc = StencilQueryService(store=blockize_fields(wave_cube, T_Q, "hilbert"),
                               layout=wlay, deadline_s=CHIP_ROI_DEADLINE_S)
    octant = suite[0][1]
    r = wsvc.query(octant)
    check(r.status == "ok" and tuple(r.payload.shape) == (2,) + octant.shape
          and torch.equal(r.payload, wave_cube[(slice(None),) + box_of(octant)].cpu()),
          f"ROI on the wave store: {r.status}")
    log(f"ROI wave store C=2: octant {r.status}, {len(r.ranges)} ranges, "
        f"{r.fetch_calls} fetches, payload {tuple(r.payload.shape)} bit-equal to "
        f"the dense slice")
    del wsvc

    # the fault matrix on the Hilbert and row-major stores (real clock)
    lay_h = StoreLayout(M=M_Q, T=T_Q, kind="hilbert")
    lay_r = StoreLayout(M=M_Q, T=T_Q, kind="row_major")
    want_o = dense[box_of(octant)]
    outcomes = {}
    svc = StencilQueryService(store=hosts["hilbert"], layout=lay_h, max_retries=3,
                              cache_blocks=CHIP_ROI_CACHE_BLOCKS,
                              deadline_s=CHIP_ROI_DEADLINE_S)
    plan = ServeFaultPlan(**CHIP_ROI_FAULTS)
    svc.fetch = plan.wrap_fetch(svc.fetch)
    r = svc.query(octant)
    check(r.status == "ok" and r.retries == 3 and r.integrity_failures == 1
          and r.fetch_calls == 4 and torch.equal(r.payload, want_o),
          f"faults recovered: {r}")
    outcomes["fail 2 + bit flip 1, 3 retries"] = r
    b0 = int(ranges_to_blocks(roi_to_ranges(lay_h, octant))[0])
    check(svc.poison_cache(b0), "the octant's first block is cached")
    r = svc.query(octant)
    check(r.status == "ok" and r.quarantined == 1 and r.cache_misses == 1
          and r.fetch_calls == 1 and torch.equal(r.payload, want_o),
          f"cache poison: {r}")
    outcomes["poisoned cache entry"] = r
    svc = StencilQueryService(store=hosts["row_major"], layout=lay_r,
                              deadline_s=CHIP_ROI_DEADLINE_S)
    svc.fetch = ServeFaultPlan(**CHIP_ROI_FAULTS).wrap_fetch(svc.fetch)
    r = svc.query(octant)
    check(r.status == "degraded" and r.missing_ranges == (r.ranges[0],)
          and served_exactly(r, want_o), f"faults exhausted: {r.status} "
          f"{r.missing_ranges[:3]}")
    outcomes["fail 2 + bit flip 1, 2 retries (row-major)"] = r
    slab = suite[2][1]
    svc = StencilQueryService(store=hosts["row_major"], layout=lay_r,
                              deadline_s=CHIP_ROI_SLOW_DEADLINE_S)
    svc.fetch = ServeFaultPlan(slow_first=10 ** 6, slow_s=CHIP_ROI_SLOW_S
                               ).wrap_fetch(svc.fetch)
    r = svc.query(slab)
    check(r.status == "degraded" and "deadline" in (r.error or "")
          and r.elapsed_s >= CHIP_ROI_SLOW_DEADLINE_S
          and served_exactly(r, dense[box_of(slab)]),
          f"deadline pressure: {r.status} {r.error}")
    outcomes["fetch slower than the deadline (row-major slab)"] = r
    svc = StencilQueryService(store=hosts["hilbert"], layout=lay_h,
                              max_in_flight=CHIP_ROI_MAX_IN_FLIGHT,
                              deadline_s=CHIP_ROI_DEADLINE_S)
    batch = svc.query_batch([roi for _, roi in suite])
    kinds_ = [r.status for r in batch]
    check(set(kinds_) <= set(QUERY_STATUSES) and "ok" in kinds_
          and "rejected" in kinds_ and svc.stats()["in_flight"] == 0
          and all(torch.equal(r.payload, dense[box_of(r.roi)])
                  for r in batch if r.status == "ok")
          and all(r.payload is None for r in batch if r.status == "rejected"),
          f"load shedding: {kinds_}")
    outcomes[f"query_batch of the suite, max_in_flight={CHIP_ROI_MAX_IN_FLIGHT}"] = batch
    for what, r in outcomes.items():
        rs = r if isinstance(r, list) else [r]
        check(all(x.status in QUERY_STATUSES for x in rs), f"{what}: untyped")
        log(f"ROI fault {what}: " + "; ".join(
            f"{x.status} ranges {len(x.ranges)} missing {len(x.missing_ranges)} "
            f"retries {x.retries} integrity {x.integrity_failures} quarantined "
            f"{x.quarantined} hits {x.cache_hits} misses {x.cache_misses} "
            f"fetches {x.fetch_calls} {1e3 * x.elapsed_s:.1f} ms" for x in rs))
    roi_row["faults"] = {what: [x.status for x in (r if isinstance(r, list) else [r])]
                         for what, r in outcomes.items()}
    # the CLI's demo in this process on the Hilbert store, its settings
    # (100 ms deadline, 256 cached blocks, 4 in flight, the faults), each
    # query's outcome and time to set beside the subprocess's below
    svc = StencilQueryService(store=hosts["hilbert"], layout=lay_h, cache_blocks=256,
                              deadline_s=0.1, max_in_flight=4)
    svc.fetch = ServeFaultPlan(**CHIP_ROI_FAULTS).wrap_fetch(svc.fetch)
    demo = _demo_rois(M_Q, T_Q, 12, 0)
    t_ = time.perf_counter()
    batch = svc.query_batch(demo)
    demo_ms = 1e3 * (time.perf_counter() - t_)
    check(all(x.status in QUERY_STATUSES for x in batch)
          and all(torch.equal(x.payload[~torch.isnan(x.payload)],
                              dense[box_of(x.roi)][~torch.isnan(x.payload)])
                  and bool(torch.isnan(x.payload).any()) == bool(x.missing_ranges)
                  for x in batch if x.payload is not None),
          "the CLI's demo in this process")
    log(f"ROI the CLI's demo in this process ({demo_ms:.1f} ms): " + "; ".join(
        f"q{i:02d} {x.status} {len(x.ranges)} ranges {x.cache_misses} misses "
        f"{1e3 * x.elapsed_s:.1f} ms" for i, x in enumerate(batch)))
    del svc, hosts, outcomes, batch

    # the CLI, as a user runs it on the card (started while the kernels'
    # checks ran): as given, then with a deadline the queries can meet
    for extra, r in zip(serve_extras, background["serve"]()):
        sub = cli_launches(r.stdout, "SERVE_LAUNCHES ") if r.returncode == 0 else {}
        lines = r.stdout.splitlines()
        check(r.returncode == 0 and "SERVE_DONE" in lines
              and sub.get("stencil_step_fused") == 4,
              f"serve CLI: exit {r.returncode}\n{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        for ln in lines:
            if ln.startswith("[serve]"):
                log(f"serve CLI {ln[:300]}")
        log(f"serve CLI --stencil --M {M_Q} --faults {' '.join(extra)}: SERVE_DONE, "
            f"its launches {sub}")
        roi_row["cli_launches"] = sub
    sync()
    log(f"ROI slice ({time.perf_counter() - t1:.1f} s)")

    # smollm-360m at full width: prefill with the flash kernel in every
    # layer, then greedy decode (which runs no kernel: masked_sdpa over the
    # cache), weights from a seeded generator
    t1 = time.perf_counter()
    lm = Model(lm_cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0))
    plain_cfg = dataclasses.replace(lm_cfg, use_flash_kernel=False)
    batch = concrete_batch(lm_cfg, ShapeSpec("chip_prefill", S_P, B_P, "prefill"),
                           seed=0, device=dev)
    logits, counts = counted(lambda: lm.prefill(batch))
    by_design = dict(_build.FLASH_DESIGN_LAUNCHES)
    check(counts == {**{n: 0 for n in counts}, "flash_attention_fwd": lm_cfg.n_layers},
          f"prefill launches {counts}, want {lm_cfg.n_layers} flash_attention_fwd")
    check(by_design == {"sm90": lm_cfg.n_layers, "simple": 0},
          f"prefill flash launches by design {by_design}, want every one sm90")
    check(logits.shape == (B_P, lm_cfg.vocab) and bool(torch.isfinite(logits).all()),
          "prefill logits not finite or misshapen")
    plain_logits = tfm.prefill(lm.params(), batch, plain_cfg)
    lm_err = (logits - plain_logits).abs().max().item()
    check(lm_err <= LM_LOGIT_TOL, f"prefill: flash vs plain attention max |d| {lm_err}")
    # the kernel inside the model against its plain version, with the
    # wrapper swapped in ops (same folds, transposes and blocks; these runs
    # are not counted): the prefill with the plain version in its place;
    # every layer's launch on that layer's own q, k, v; and, in f32
    # activations, the prefill with the kernel against its plain twin
    kernel_fwd = kops.flash_attention_fwd
    layer_errs = []

    def both_fwd(q, k, v, *, causal, block_q, block_k, schedule):
        o = kernel_fwd(q, k, v, causal=causal, block_q=block_q,
                       block_k=block_k, schedule=schedule)
        layer_errs.append(flash_err(o, ref.flash_attention_ref(q, k, v, causal=causal),
                                    f"prefill layer {len(layer_errs)}"))
        return o

    def prefill_with(fwd, cfg):
        kops.flash_attention_fwd = fwd
        try:
            return tfm.prefill(lm.params(), batch, cfg)
        finally:
            kops.flash_attention_fwd = kernel_fwd

    ref_err = (logits - prefill_with(plain_fwd, lm_cfg)).abs().max().item()
    check(ref_err <= LM_LOGIT_TOL, f"prefill: flash kernel vs its plain version max |d| {ref_err}")
    prefill_with(both_fwd, lm_cfg)
    check(len(layer_errs) == lm_cfg.n_layers, f"{len(layer_errs)} layers compared")
    f32_cfg = dataclasses.replace(lm_cfg, activation_dtype="float32")
    f32_logits = prefill_with(kernel_fwd, f32_cfg)
    f32_err = (f32_logits - prefill_with(plain_fwd, f32_cfg)).abs().max().item()
    check(f32_err <= LM_F32_LOGIT_TOL,
          f"f32 prefill: flash kernel vs its plain version max |d| {f32_err}")
    del plain_logits, f32_logits
    log(f"main {lm_cfg.name} prefill: B={B_P} S={S_P} launches "
        f"{counts['flash_attention_fwd']} flash_attention_fwd (by design "
        f"{by_design}); every layer's "
        f"launch against the plain version on its own q, k, v max |d| "
        f"{max(layer_errs):.4g}; logits max |d| in f32 activations against "
        f"the plain version {f32_err:.4g}; in bf16 against the plain version "
        f"{ref_err:.4g} and against plain attention {lm_err:.4g} (max |logit| "
        f"{logits.abs().max().item():.4g}, std {logits.std().item():.4g})")
    B_D, P_D, N_D = (lm_sizes.CHIP_DECODE_BATCH, lm_sizes.CHIP_PROMPT_LEN,
                     lm_sizes.CHIP_NEW_TOKENS)
    prompts = concrete_batch(lm_cfg, ShapeSpec("chip_decode", P_D, B_D, "prefill"),
                             seed=1, device=dev)["tokens"]
    toks, counts = counted(lambda: greedy_decode(lm, prompts, N_D, P_D + N_D + 1))
    check(not any(counts.values()), f"greedy_decode launched {counts}")
    check(toks.shape == (B_D, N_D) and toks.dtype == torch.int32
          and bool(((toks >= 0) & (toks < lm_cfg.vocab)).all()),
          f"greedy_decode returned {tuple(toks.shape)} {toks.dtype}")
    cache = lm.init_cache(B_D, P_D + N_D + 1, torch.float32)
    for t in range(P_D):
        dec_logits, cache = lm.decode(cache, {"tokens": prompts[:, t:t + 1], "cur": t})
    pre_logits = lm.prefill({"tokens": prompts})
    dec_err = (dec_logits[:, 0] - pre_logits).abs().max().item()
    check(dec_err <= LM_LOGIT_TOL, f"decode vs prefill logits max |d| {dec_err}")
    agree = int((dec_logits[:, 0].argmax(-1) == pre_logits.argmax(-1)).sum())
    first = int((toks[:, 0] == pre_logits.argmax(-1)).sum())
    sync()
    log(f"main {lm_cfg.name} greedy_decode: {B_D} requests, {P_D}-token "
        f"prompts, {N_D} new tokens, no kernel launches; decode's logits at "
        f"the last prompt position against the prefill's max |d| "
        f"{dec_err:.4g}; argmax agrees {agree}/{B_D}, first new token equals "
        f"the prefill's argmax {first}/{B_D} ({time.perf_counter() - t1:.1f} s)")

    sync()
    # flash_attention_bwd's main path is the training step (train_phase
    # asserts its 32 launches a step there)
    for name, n in main_launches.items():
        check(n > 0 or name == "flash_attention_bwd",
              f"{name} was not launched on its main path")
    log(f"main paths: launches {main_launches} "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---------------------------------------------------------------- timings
    t0 = time.perf_counter()
    kernels = []
    nb = (M_MAIN // T_MAIN) ** 3
    T3 = T_MAIN ** 3

    def in_turns(variants, **kw):
        """ms of each variant, timed in turns (a, b, c, c, b, a), and the
        mean of its two readings."""
        got = {name: [] for name in variants}
        for name in [*variants, *reversed(variants)]:
            got[name].append(cuda_ms(variants[name], **kw))
        return {name: statistics.mean(t) for name, t in got.items()}, got

    # stencil_step_fused at the main path's shape: gol, hilbert store; the
    # first design, the Hopper block design forced without and with its
    # overlap and as it launches, the group design with its next window
    # streamed in while the result is written, and as it launches (the next
    # window prefetched beside the substeps: the row's time), in turns
    out = torch.empty_like(store)
    fused = lambda: K.stencil_step_fused(store, w1, nbr_h, g=G_MAIN, S=S_MAIN,
                                         out=out)
    plain = lambda: ref.stencil_fused_ref(store, w1, nbr_h, S=S_MAIN)
    err = (fused() - plain()).abs().max().item()

    def fused_by(design, overlap=None):
        return lambda: K._fused_on_card(design, store, w1, nbr_h, None, out, nb,
                                        g=G_MAIN, S=S_MAIN, rule="gol",
                                        bc=periodic, overlap=overlap,
                                        groups=groups_h)

    fused_variants = {"first design": fused_by("simple"),
                      "Hopper design without overlap": fused_by("sm90", False),
                      "Hopper design with overlap": fused_by("sm90", True),
                      "Hopper design": fused_by("sm90"),
                      "group design streaming": fused_by("sm90_group", False),
                      "group design": fused_by("sm90_group")}
    check(K.fused_design(T_MAIN, G_MAIN, S_MAIN, 1, cube=True) == "sm90_group",
          "the main path's launch is not of the group design")
    for name, fn in fused_variants.items():
        fn()
        check(torch.equal(out, plain()), f"fused, {name}, != plain at M={M_MAIN}")
    fused_ms, fused_reads = in_turns(fused_variants)
    # The function's own work: S timesteps of a (multiply, add) per tap on
    # every site; one read and one write of the store, and its two tables
    # (27 neighbour ids, 6 face flags per block) and the weights read once.
    ops = S_MAIN * nb * T3 * 2 * TAPS
    b_ms, b_by = bound(4 * (2 * nb * T3 + nb * 27 + nb * 6 + TAPS), ops)
    # The design's own work, a separate model: each substep also recomputes
    # the halo sites that the shrinking window still needs, around a block
    # (the block design) or around a group of 2x2x2 blocks (the group design).
    def tile_ops(edge, tiles, S_=S_MAIN):
        return sum(tiles * (edge + 2 * G_MAIN * (S_ - 1 - u)) ** 3 * 2 * TAPS
                   for u in range(S_))

    design_ops = tile_ops(T_MAIN, nb)
    group_ops = tile_ops(2 * T_MAIN, nb // 8)
    # Without FMA every multiply and add is one f32 instruction, issued at
    # half the 67 TFLOP/s that count an FMA as two operations
    floor = lambda n_ops: 1e3 * n_ops / (F32_FLOP_PER_S / 2)
    log(f"fused work per launch: {ops / 1e9:.3f} GFLOP for the function, "
        f"{design_ops / 1e9:.3f} GFLOP for the block design with its recomputed "
        f"halo sites ({design_ops / ops:.2f}x; "
        f"{1e3 * design_ops / F32_FLOP_PER_S:.4f} ms at 67 TFLOP/s), "
        f"{group_ops / 1e9:.3f} GFLOP for the group design ({group_ops / ops:.3f}x); "
        f"without FMA the function's floor is {floor(ops):.4f} ms, the block "
        f"design's {floor(design_ops):.4f} ms, the group design's "
        f"{floor(group_ops):.4f} ms")

    def work_of(name):
        return group_ops if name.startswith("group design") else design_ops

    log(f"stencil_step_fused M={M_MAIN} T={T_MAIN} S={S_MAIN} g={G_MAIN} gol, in "
        f"turns: " + "; ".join(
            f"{name} {fused_ms[name]:.4f} ms (readings "
            f"{', '.join(f'{t:.4f}' for t in fused_reads[name])}; "
            f"{work_of(name) / fused_ms[name] / 1e9:.1f} G f32 instructions/s of "
            f"the design's work, {100 * floor(work_of(name)) / fused_ms[name]:.1f}% "
            f"of its non-FMA floor)" for name in fused_variants))
    # the wave cells' launch (M=256, C=2, S=4, Hilbert store): the group
    # design the wrapper launches and the block design, in turns; u's taps
    # alone are summed, so the work is gol's, and the store moves 2 channels
    wst = blockize_fields(fields, T_MAIN, "hilbert")
    wout = torch.empty_like(wst)
    wave_variants = {d: (lambda d=d: K._fused_on_card(
        d, wst, w1, nbr_h, None, wout, nb, g=G_MAIN, S=S_MAIN, rule="wave",
        bc=periodic, groups=groups_h)) for d in ("sm90_group", "sm90")}
    wave_ms, wave_reads = in_turns(wave_variants)
    wb_ms, wb_by = bound(4 * (2 * 2 * nb * T3 + nb * 27 + TAPS), ops)
    log(f"stencil_step_fused M={M_MAIN} T={T_MAIN} S={S_MAIN} g={G_MAIN} wave "
        f"(the benchmark's cells), in turns: group design "
        f"{wave_ms['sm90_group']:.4f} ms (readings "
        f"{', '.join(f'{t:.4f}' for t in wave_reads['sm90_group'])}), block design "
        f"{wave_ms['sm90']:.4f} ms ({', '.join(f'{t:.4f}' for t in wave_reads['sm90'])}); "
        f"bound {wb_ms:.4f} ms by {wb_by} ({100 * wb_ms / wave_ms['sm90_group']:.2f}% "
        f"of it), the group design's non-FMA floor at {group_ops / ops:.3f}x the "
        f"function's work {floor(group_ops):.4f} ms "
        f"({100 * floor(group_ops) / wave_ms['sm90_group']:.1f}% of it)")
    del wst, wout
    kernels.append(dict(name="stencil_step_fused", ms=fused_ms["group design"],
                        plain_ms=cuda_ms(plain, reps=3, inner=1),
                        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None, block_design_ms=fused_ms["Hopper design"],
                        group_streaming_ms=fused_ms["group design streaming"],
                        wave_ms=wave_ms["sm90_group"],
                        wave_block_design_ms=wave_ms["sm90"], wave_bound_ms=wb_ms,
                        group_floor_ms=floor(group_ops),
                        block_floor_ms=floor(design_ops)))

    # stencil_sum_resident at the main path's shape, both designs in turns
    res = lambda: K.stencil_sum_resident(store, w1, nbr_h, g=G_MAIN, out=out)
    plain = lambda: ref.stencil_sum_resident_ref(store, w1, nbr_h)
    err = (res() - plain()).abs().max().item()
    halo5, w5 = halo_main[:, None], w1[None, None]
    b_ms, b_by = bound(4 * (2 * nb * T3 + nb * 27 + TAPS), nb * T3 * 2 * TAPS)

    def resident_by(design, overlap=None):
        return lambda: K._resident_on_card(design, store, w1, nbr_h, out,
                                           g=G_MAIN, overlap=overlap)

    res_variants = {"first design": resident_by("simple"),
                    "Hopper design without overlap": resident_by("sm90", False),
                    "Hopper design with overlap": resident_by("sm90", True),
                    "Hopper design": resident_by("sm90")}
    for name, fn in res_variants.items():
        fn()
        check(torch.equal(out, plain()), f"resident, {name}, != plain at M={M_MAIN}")
    res_ms, res_reads = in_turns(res_variants)
    log(f"stencil_sum_resident M={M_MAIN} T={T_MAIN} g={G_MAIN}, in turns: "
        + "; ".join(f"{name} {res_ms[name]:.4f} ms (readings "
                    f"{', '.join(f'{t:.4f}' for t in res_reads[name])})"
                    for name in res_variants)
        + f"; bound {b_ms:.4f} ms by {b_by}")
    kernels.append(dict(name="stencil_sum_resident", ms=res_ms["Hopper design"],
                        plain_ms=cuda_ms(plain, reps=3, inner=1),
                        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                        library_ms=cuda_ms(lambda: F.conv3d(halo5, w5))))

    # stencil_sum_blocks at the repack path's shape (M=128: its 16.4 MB of
    # blocks stay in the 50 MB L2 between timed calls) and at M=256, T=8,
    # g=1 in f32 and bf16 (131.1 and 65.5 MB of blocks): each design, as
    # launched and the first design, in turns, beside conv3d on the same
    # blocks and the bound (each input byte read once, each output byte
    # written once; f32 operations at 67 TFLOP/s)
    T_R, G_R = CHIP_REPACK.block_T, CHIP_REPACK.g
    taps_r = (2 * G_R + 1) ** 3
    w_r = uniform_weights(G_R, dev)

    def blocks_row(cube_, dtype):
        halo_ = blockize_with_halo(cube_.contiguous(), T_R, G_R, "hilbert").to(dtype)
        nb_ = halo_.shape[0]
        out_ = torch.empty((nb_, T_R, T_R, T_R), device=dev)
        design = K.blocks_design(T_R, G_R, dtype)
        variants = {"Hopper design": lambda: K.stencil_sum_blocks(
                        halo_, w_r, g=G_R, out=out_),
                    "first design": lambda: K._blocks_on_card(
                        "simple", halo_, w_r, out_, g=G_R)}
        plain_ = lambda: ref.stencil_sum_ref(halo_, w_r)
        for name, fn in variants.items():
            fn()
            check(torch.equal(out_, plain_()), f"blocks, {name}, {dtype} != plain")
        ms_, reads = in_turns(variants)
        # device time per launch (profiler): at M=128 a launch is shorter
        # than the host's cost of calling it, which back-to-back CUDA-event
        # timings then measure instead
        dev_ = {n: device_ms(fn, n=100) for n, fn in variants.items()}
        item = halo_.element_size()
        b_ms_, b_by_ = bound(item * nb_ * (T_R + 2 * G_R) ** 3 + 4 * nb_ * T_R ** 3
                             + 4 * taps_r, nb_ * T_R ** 3 * 2 * taps_r)
        lib_ms = cuda_ms(lambda: F.conv3d(halo_[:, None], w_r[None, None].to(dtype)))
        # the rate the card reaches on a plain copy of the same blocks (one
        # read and one write of each byte), as a yardstick for the bound
        n_in, n_out = item * nb_ * (T_R + 2 * G_R) ** 3, 4 * nb_ * T_R ** 3
        twin = torch.empty_like(halo_)
        copy_ms = cuda_ms(lambda: twin.copy_(halo_))
        del twin
        M_ = cube_.shape[0]
        log(f"stencil_sum_blocks M={M_} T={T_R} g={G_R} {dtype} ({design} design "
            f"as launched), in turns: "
            + "; ".join(f"{n} {ms_[n]:.4f} ms (readings "
                        f"{', '.join(f'{t:.4f}' for t in reads[n])}; "
                        f"{100 * b_ms_ / ms_[n]:.1f}% of the bound, "
                        f"{(n_in + n_out) / ms_[n] / 1e9:.2f} TB/s; {dev_[n][1]} "
                        f"{dev_[n][0]:.4f} ms)" for n in variants)
            + f"; conv3d {lib_ms:.4f} ms; bound {b_ms_:.4f} ms by {b_by_} "
            f"({n_in / 1e6:.1f} MB in, {n_out / 1e6:.1f} MB out); a copy of the "
            f"blocks {copy_ms:.4f} ms ({2 * n_in / copy_ms / 1e9:.2f} TB/s)")
        return ms_, dev_, b_ms_, b_by_, lib_ms, plain_, out_

    # the row: the repack path's shape, device time per launch (profiler),
    # CUDA events around back-to-back calls beside it
    r_ms, r_dev, b_ms, b_by, lib_ms, plain, out_r = blocks_row(rep_app.cube,
                                                               torch.float32)
    err = (out_r - plain()).abs().max().item()
    row = dict(name="stencil_sum_blocks", ms=r_dev["Hopper design"][0],
               plain_ms=cuda_ms(plain, reps=3, inner=3), max_abs_err=err,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               per_call_ms=r_ms["Hopper design"],
               first_design_ms=r_dev["first design"][0])
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        m_ms, _, m_b, _, m_lib, m_plain, _ = blocks_row(cube, dtype)
        row.update({f"m256_{tag}_ms": m_ms["Hopper design"],
                    f"m256_{tag}_first_design_ms": m_ms["first design"],
                    f"m256_{tag}_bound_ms": m_b, f"m256_{tag}_library_ms": m_lib,
                    f"m256_{tag}_plain_ms": cuda_ms(m_plain, reps=3, inner=1)})
        log(f"stencil_sum_blocks M={cube.shape[0]} {dtype}: plain version "
            f"{row[f'm256_{tag}_plain_ms']:.3f} ms")
    kernels.append(row)
    # gather_rows at the distributed path's deep-face shape: the i0 face at
    # h = S·g = 4 of the M=256, T=8 Hilbert block store (8,192 rows of 64
    # f32; a k face is 4,096 rows). The function reads each row and index
    # once and writes each row once.
    src = blockize(cube_d, T_D, "hilbert").reshape(-1, LINE)
    for face in ("k0", "i0"):
        _, rows = face_rows("hilbert", S_D * G_MAIN, face)
        R = rows.shape[0]
        buf = torch.empty((R, LINE), device=dev)
        gat = lambda: gather_rows(src, rows, out=buf)
        plain = lambda: ref.gather_rows_ref(src, rows)
        lib = lambda: torch.index_select(src, 0, rows)
        err = (gat() - plain()).abs().max().item()
        b_ms, b_by = bound(2 * R * LINE * 4 + 4 * R, 0)
        # device time per launch (profiler); per call on the host's clock
        # (CUDA events around back-to-back calls), wrapper included
        (g_ms, g_how), (p_ms, p_how), (l_ms, l_how) = (
            device_ms(fn) for fn in (gat, plain, lib))
        row = dict(name="gather_rows", ms=g_ms, plain_ms=p_ms, max_abs_err=err,
                   bound_ms=b_ms, bound_by=b_by, library_ms=l_ms)
        log(f"gather_rows {face} h={S_D * G_MAIN}: {R} rows, {g_how} "
            f"{g_ms:.5f} ms (plain {p_how} {p_ms:.5f}, index_select {l_how} "
            f"{l_ms:.5f}, bound {b_ms:.5f} ms); per call "
            f"{cuda_ms(gat, inner=100):.5f} ms (plain "
            f"{cuda_ms(plain, inner=100):.5f}, index_select "
            f"{cuda_ms(lib, inner=100):.5f})")
    kernels.append(row)  # the i face, the larger of the two

    # fault F2's fp8 instances at the main path's shape (M=256, T=8, g=1;
    # the fused step S=4, gol): each beside its plain version and its bound
    # (one byte per stored element; f32 out for the tap sums), and conv3d
    # in f16 on the same values as a yardstick (no PyTorch call computes
    # on fp8 stores, so library_ms stays the f32 row's)
    by_name = {k["name"]: k for k in kernels}
    for dtype, tag in zip(FP8, ("e4m3", "e5m2")):
        st8 = ref.round_to(store, dtype)
        out8 = torch.empty_like(st8)
        acc8 = torch.empty(store.shape, device=dev)
        halo8 = ref.round_to(halo_main, dtype)
        rows = {
            "stencil_step_fused": (
                lambda: K.stencil_step_fused(st8, w1, nbr_h, g=G_MAIN, S=S_MAIN,
                                             out=out8),
                lambda: ref.stencil_fused_ref(st8, w1, nbr_h, S=S_MAIN),
                bound(2 * nb * T3 + 4 * (nb * 27 + nb * 6 + TAPS),
                      S_MAIN * nb * T3 * 2 * TAPS)),
            "stencil_sum_resident": (
                lambda: K.stencil_sum_resident(st8, w1, nbr_h, g=G_MAIN, out=acc8),
                lambda: ref.stencil_sum_resident_ref(st8, w1, nbr_h),
                bound(nb * T3 + 4 * nb * T3 + 4 * (nb * 27 + TAPS),
                      nb * T3 * 2 * TAPS)),
            "stencil_sum_blocks": (
                lambda: K.stencil_sum_blocks(halo8, w1, g=G_MAIN, out=acc8),
                lambda: ref.stencil_sum_ref(halo8, w1),
                bound(halo8.numel() + 4 * nb * T3 + 4 * TAPS, nb * T3 * 2 * TAPS)),
        }
        conv16 = cuda_ms(lambda: F.conv3d(halo8.to(torch.float16)[:, None],
                                          w1.to(torch.float16)[None, None]))
        for name, (fn, plain, (b_ms, b_by)) in rows.items():
            check(same_bits(fn(), plain()), f"{name} {dtype} != plain at M={M_MAIN}")
            k_ms, p_ms = cuda_ms(fn, reps=3, inner=5), cuda_ms(plain, reps=3, inner=1)
            by_name[name].update({f"{tag}_ms": k_ms, f"{tag}_plain_ms": p_ms,
                                  f"{tag}_bound_ms": b_ms,
                                  f"{tag}_f16_conv3d_ms": conv16})
            log(f"{name} {dtype} M={M_MAIN} T={T_MAIN} (first design): "
                f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms by "
                f"{b_by} ({100 * b_ms / k_ms:.1f}% of it); conv3d in f16 on the "
                f"same blocks {conv16:.4f} ms")
        del st8, out8, acc8, halo8
    # the checkpointed main path's readings (the slice's phase above)
    by_name["stencil_step_fused"]["checkpointed_main_path"] = slice_row
    by_name["stencil_step_fused"]["roi_service"] = roi_row
    for k in kernels:
        check(k["max_abs_err"] == 0.0, f"{k['name']} differs from plain: {k}")
        k.update(route="cuda", source=SOURCES[k["name"]],
                 replaces=REPLACES[k["name"]], launches=main_launches[k["name"]])
        log(f"kernel {k['name']}: {k['ms']:.4f} ms (plain {k['plain_ms']:.3f} ms, "
            f"library {k['library_ms']}, bound {k['bound_ms']:.4f} ms by {k['bound_by']})")

    # flash_attention_fwd at the prefill's shape (the folded tensors of one
    # layer) per schedule, beside its plain version, the simple design on
    # the same tensors, and SDPA on the same tensors viewed (B, H, S, D).
    # The function's own work: 4·D operations per (query, visible key)
    # pair; q and o read and written once, k and v read once un-repeated
    # (n_kv_heads of n_heads). The Hopper design multiplies P twice (its
    # bf16 halves): 1.5x those operations, reported apart.
    def flash_ops(bh, s_):
        return 4 * HD * bh * s_ * (s_ + 1) // 2

    def flash_fn(q, k, v, sched, design=None):
        if design is None:
            return lambda: flash_attention_fwd(q, k, v, causal=True,
                                               block_q=FLASH_BLOCK,
                                               block_k=FLASH_BLOCK, schedule=sched)
        return lambda: FA._fwd_on_card(design, q, k, v, True, FLASH_BLOCK,
                                       FLASH_BLOCK, sched)

    f_ms = {sched: cuda_ms(flash_fn(fq, fk, fv, sched), inner=20)
            for sched in FLASH_SCHEDULES}
    simple_ms = {sched: cuda_ms(flash_fn(fq, fk, fv, sched, "simple"), reps=3,
                                inner=3) for sched in FLASH_SCHEDULES}
    plain = lambda: ref.flash_attention_ref(fq, fk, fv)
    q4, k4, v4 = (t.view(B_P, H, S_P, HD) for t in (fq, fk, fv))
    sdpa = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    sdpa_err = (sdpa().reshape(fq.shape).float()
                - flash_want.float()).abs().max().item()
    BH = fq.shape[0]
    f_ops = flash_ops(BH, S_P)
    f_bytes = 2 * (2 * fq.numel() + 2 * fk.numel() * KVH // H)
    b_ms, b_by = bound(f_bytes, f_ops, BF16_FLOP_PER_S)
    row = dict(name="flash_attention_fwd", ms=f_ms[lm_cfg.flash_schedule],
               plain_ms=cuda_ms(plain, reps=3, inner=1), max_abs_err=flash_main_err,
               bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(sdpa, inner=20))
    log(f"flash_attention_fwd {tuple(fq.shape)} bf16 causal, Hopper design: "
        + ", ".join(f"{s_} {ms:.4f} ms ({f_ops / ms / 1e9:.1f} TFLOP/s)"
                    for s_, ms in f_ms.items())
        + "; simple design on the same tensors: "
        + ", ".join(f"{s_} {ms:.4f} ms" for s_, ms in simple_ms.items())
        + f"; plain {row['plain_ms']:.3f} ms; SDPA {row['library_ms']:.4f} ms "
        f"(max |d| to plain {sdpa_err:.3g}); bound {b_ms:.4f} ms by {b_by} "
        f"({f_ops / 1e9:.2f} GFLOP, {f_bytes / 1e6:.1f} MB), "
        f"{100 * b_ms / row['ms']:.1f}% of it reached; the design's work with "
        f"P in two halves {1.5 * f_ops / 1e9:.2f} GFLOP "
        f"({1.5 * f_ops / row['ms'] / 1e9:.1f} TFLOP/s)")
    row.update(route="cuda", source=SOURCES[row["name"]],
               replaces=REPLACES[row["name"]], launches=main_launches[row["name"]])
    kernels.append(row)
    # the same at S=32768, BH=15 (one sequence's heads): K and V of all
    # heads (126 MB) exceed the 50 MB L2, so the order in which the curve
    # hands out q blocks could matter
    l_ops = flash_ops(H, L_S)
    l_ms = {sched: cuda_ms(flash_fn(lq, lk, lv, sched), reps=3, inner=3)
            for sched in FLASH_SCHEDULES}
    l_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        lq[None], lk[None], lv[None], is_causal=True), reps=3, inner=3)
    l_bound, l_by = bound(2 * 4 * H * L_S * HD, l_ops, BF16_FLOP_PER_S)
    log(f"flash_attention_fwd S={L_S} BH={H} bf16 causal, Hopper design: "
        + ", ".join(f"{s_} {ms:.4f} ms ({l_ops / ms / 1e9:.1f} TFLOP/s, "
                    f"{100 * l_bound / ms:.1f}% of the bound)"
                    for s_, ms in l_ms.items())
        + f"; SDPA {l_sdpa:.4f} ms; bound {l_bound:.4f} ms by {l_by} "
        f"({l_ops / 1e12:.3f} TFLOP)")
    # the simple design keeps f32 (and the other bf16 shapes): its time at
    # the prefill's shape in f32, against 67 TFLOP/s on the CUDA cores
    f32q, f32k, f32v = (t.float() for t in (fq, fk, fv))
    s32_ms = cuda_ms(flash_fn(f32q, f32k, f32v, lm_cfg.flash_schedule), reps=3, inner=3)
    s32_err = (flash_fn(f32q, f32k, f32v, lm_cfg.flash_schedule)()
               - ref.flash_attention_ref(f32q, f32k, f32v)).abs().max().item()
    s32_bound, s32_by = bound(2 * f_bytes, f_ops, F32_FLOP_PER_S)
    s32_plain = cuda_ms(lambda: ref.flash_attention_ref(f32q, f32k, f32v), reps=3,
                        inner=1)
    s32_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        *(t.view(B_P, H, S_P, HD) for t in (f32q, f32k, f32v)), is_causal=True),
        reps=3, inner=3)
    log(f"flash_attention_fwd {tuple(fq.shape)} f32 causal, simple design "
        f"({lm_cfg.flash_schedule}): {s32_ms:.4f} ms ({f_ops / s32_ms / 1e9:.1f} "
        f"TFLOP/s), max |d| to plain {s32_err:.3g}; plain {s32_plain:.3f} ms; "
        f"SDPA {s32_sdpa:.4f} ms; bound {s32_bound:.4f} ms by {s32_by} at "
        f"67 TFLOP/s")
    del lq, lk, lv, f32q, f32k, f32v
    # F1's head dim of 256 at a gemma3-1b-like shape (16 heads of S=2048,
    # bf16, causal, 128-blocks, Morton): the simple design, beside its plain
    # version and SDPA (a yardstick the port never calls), against the
    # bound of its operations at 989 TFLOP/s (bf16)
    GB, GS, GD = 16, 2048, 256
    gq, gk, gv = (randn(GB, GS, GD, dtype=torch.bfloat16) for _ in range(3))
    check(flash_design(torch.bfloat16, GD, FLASH_BLOCK, FLASH_BLOCK) == "simple",
          "D=256 takes the simple design")
    g_fn = lambda: flash_attention_fwd(gq, gk, gv, causal=True, block_q=FLASH_BLOCK,
                                       block_k=FLASH_BLOCK, schedule="morton")
    g_plain = lambda: ref.flash_attention_ref(gq, gk, gv)
    g_err = flash_err(g_fn(), g_plain(), f"{(GB, GS, GD)} bf16 causal")
    g_ms = cuda_ms(g_fn, reps=3, inner=3)
    g_plain_ms = cuda_ms(g_plain, reps=3, inner=1)
    g_sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        gq[None], gk[None], gv[None], is_causal=True), reps=3, inner=10)
    g_ops = 4 * GD * GB * GS * (GS + 1) // 2
    g_bound, g_by = bound(2 * 4 * GB * GS * GD, g_ops, BF16_FLOP_PER_S)
    log(f"flash_attention_fwd {(GB, GS, GD)} bf16 causal morton, simple design "
        f"(two threads a q row, keys staged 64 at a time): {g_ms:.4f} ms "
        f"({g_ops / g_ms / 1e9:.1f} TFLOP/s, {100 * g_bound / g_ms:.2f}% of the "
        f"bound), max |d| to plain {g_err:.3g}; plain {g_plain_ms:.3f} ms; SDPA "
        f"{g_sdpa:.4f} ms; bound {g_bound:.4f} ms by {g_by} ({g_ops / 1e9:.2f} GFLOP)")
    del gq, gk, gv
    # F3 and F1's new instances of the simple design, causal, 128-blocks,
    # Morton: f16 and fp8 at BH=60, S=2048, D=64 (the bound at 989 TFLOP/s
    # for f16, 1979 for fp8; SDPA in f16 beside the f16 one, none for fp8,
    # which no PyTorch call takes), and D ∈ {320, 512, 1024} at BH=16,
    # S=2048 in bf16 and f32 beside SDPA in the same dtype. Bytes: q, k, v
    # read and o written once.
    frow = next(k for k in kernels if k["name"] == "flash_attention_fwd")
    new_cases = [((60, 2048, 64), dt, None if dt in FP8 else dt)
                 for dt in (torch.float16,) + FP8]
    new_cases += [((16, 2048, D), dt, dt) for D in (320, 512, 1024)
                  for dt in (torch.bfloat16, torch.float32)]
    peak = {torch.float16: F16_FLOP_PER_S, torch.bfloat16: BF16_FLOP_PER_S,
            torch.float32: F32_FLOP_PER_S, FP8[0]: FP8_FLOP_PER_S,
            FP8[1]: FP8_FLOP_PER_S}
    for (nbh, ns, nd), dt, lib_dt in new_cases:
        xq, xk, xv = (randn(nbh, ns, nd, dtype=dt) for _ in range(3))
        x_fn = lambda: flash_attention_fwd(xq, xk, xv, causal=True,
                                           block_q=FLASH_BLOCK,
                                           block_k=FLASH_BLOCK, schedule="morton")
        x_plain = lambda: ref.flash_attention_ref(xq, xk, xv)
        x_err = flash_err(x_fn(), x_plain(), f"{(nbh, ns, nd)} {dt} timed")
        x_ms = cuda_ms(x_fn, reps=3, inner=3)
        x_plain_ms = cuda_ms(x_plain, reps=3, inner=1)
        x_lib = None if lib_dt is None else cuda_ms(
            lambda: F.scaled_dot_product_attention(xq[None], xk[None], xv[None],
                                                   is_causal=True),
            reps=3, inner=3)
        x_ops = 4 * nd * nbh * ns * (ns + 1) // 2
        x_bound, x_by = bound(4 * xq.numel() * xq.element_size(), x_ops, peak[dt])
        tag = f"{str(dt).split('.')[1]}_d{nd}"
        frow.update({f"{tag}_ms": x_ms, f"{tag}_plain_ms": x_plain_ms,
                     f"{tag}_bound_ms": x_bound, f"{tag}_library_ms": x_lib,
                     f"{tag}_max_abs_err": x_err})
        log(f"flash_attention_fwd {(nbh, ns, nd)} {dt} causal morton, simple "
            f"design: {x_ms:.4f} ms ({x_ops / x_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * x_bound / x_ms:.2f}% of the bound), max |d| to plain "
            f"{x_err:.3g}; plain {x_plain_ms:.3f} ms; SDPA "
            + ("none (no PyTorch call takes fp8)" if x_lib is None
               else f"in {lib_dt} {x_lib:.4f} ms")
            + f"; bound {x_bound:.4f} ms by {x_by} ({x_ops / 1e9:.2f} GFLOP)")
        del xq, xk, xv
    # F1 above 1024 (the wide instance; 128-blocks, Morton, causal) at BH=4,
    # S=256, and F4: both designs at BH=65,540 (S=64, D=64, 64-blocks), each
    # beside its plain version, SDPA in the same dtype and its bound
    xcases = [((4, 256, D), dt, FLASH_BLOCK) for D in (1152, 2048, 4096)
              for dt in (torch.float32, torch.bfloat16)]
    xcases += [((65540, 64, 64), dt, 64) for dt in (torch.bfloat16, torch.float32)]
    for (nbh, ns, nd), dt, blk in xcases:
        xq, xk, xv = (randn(nbh, ns, nd, dtype=dt) for _ in range(3))
        design = flash_design(dt, nd, blk, blk)
        x_fn = lambda: flash_attention_fwd(xq, xk, xv, causal=True, block_q=blk,
                                           block_k=blk, schedule="morton")
        x_plain = lambda: ref.flash_attention_ref(xq, xk, xv)
        x_err = flash_err(x_fn(), x_plain(), f"{(nbh, ns, nd)} {dt} {design} timed")
        x_ms = cuda_ms(x_fn, reps=3, inner=3)
        x_plain_ms = cuda_ms(x_plain, reps=3, inner=1)
        # SDPA on the heads as (B, H) with H <= 65535: its f32 kernel too
        # puts the heads on a grid axis, and at one batch row of 65,540
        # heads its launch fails (invalid configuration)
        b_ = next(b for b in range(1, nbh + 1) if nbh % b == 0 and nbh // b <= 65535)
        x4 = [t.view(b_, nbh // b_, ns, nd) for t in (xq, xk, xv)]
        x_lib = cuda_ms(lambda: F.scaled_dot_product_attention(*x4, is_causal=True),
                        reps=3, inner=3)
        x_ops = 4 * nd * nbh * ns * (ns + 1) // 2
        x_bound, x_by = bound(4 * xq.numel() * xq.element_size(), x_ops, peak[dt])
        tag = f"{str(dt).split('.')[1]}_" + (f"d{nd}" if nbh < 65536 else f"bh{nbh}")
        frow.update({f"{tag}_ms": x_ms, f"{tag}_plain_ms": x_plain_ms,
                     f"{tag}_bound_ms": x_bound, f"{tag}_library_ms": x_lib,
                     f"{tag}_max_abs_err": x_err})
        log(f"flash_attention_fwd {(nbh, ns, nd)} {dt} causal morton {blk}-blocks, "
            f"{design} design: {x_ms:.4f} ms ({x_ops / x_ms / 1e9:.1f} TFLOP/s, "
            f"{100 * x_bound / x_ms:.2f}% of the bound), max |d| to plain "
            f"{x_err:.3g}; plain {x_plain_ms:.3f} ms; SDPA in {dt} on "
            f"{tuple(x4[0].shape)} {x_lib:.4f} ms; bound {x_bound:.4f} ms by "
            f"{x_by} ({x_ops / 1e9:.2f} GFLOP)")
        del xq, xk, xv, x4

    # the repack path Gol3d.run at CHIP_REPACK: ms per timestep end to end
    # (host clock, median of 5 after a warm-up) and the repack kernel's
    # share of it (its CUDA-event time per launch, one launch a timestep)
    rep_walls = []
    rep_app.run(CHIP_REPACK_STEPS)
    sync()
    for _ in range(5):
        t1 = time.perf_counter()
        rep_app.run(CHIP_REPACK_STEPS)
        sync()
        rep_walls.append(1e3 * (time.perf_counter() - t1) / CHIP_REPACK_STEPS)
    rep_ms = statistics.median(rep_walls)
    log(f"repack Gol3d.run M={CHIP_REPACK.M} K={CHIP_REPACK_STEPS}: "
        f"{rep_ms:.4f} ms per timestep end to end (readings "
        f"{', '.join(f'{t:.4f}' for t in rep_walls)}); the stencil_sum_blocks "
        f"kernel {r_dev['Hopper design'][0]:.4f} ms of it on the device "
        f"({100 * r_dev['Hopper design'][0] / rep_ms:.1f}%), "
        f"{r_ms['Hopper design']:.4f} ms per call on the host's clock")

    # the main path per ordering: end to end (host clock) and kernels only
    item_bytes = 4 * fused_items_per_launch(M_MAIN, T_MAIN, G_MAIN, S_MAIN)
    model = resident_bytes_per_step(M_MAIN, T_MAIN, G_MAIN, K_MAIN, S=S_MAIN)
    log(f"model: {item_bytes / 1e6:.1f} MB streamed per fused launch "
        f"({1e3 * item_bytes / HBM_BYTES_PER_S:.4f} ms at 3.35 TB/s), "
        f"compulsory {8 * M_MAIN ** 3 / 1e6:.1f} MB per launch, "
        f"{model / 1e6:.1f} MB modelled per timestep at K={K_MAIN}")
    for kind, app in apps.items():
        app.run_resident(K_MAIN)
        sync()
        walls = []
        for _ in range(5):
            t1 = time.perf_counter()
            app.run_resident(K_MAIN)
            sync()
            walls.append(time.perf_counter() - t1)
        pipe = app.resident_pipeline()
        st = pipe.to_blocks(app.cube)
        run = pipe.run_fn(K_MAIN)
        k_ms = cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN
        log(f"timestep {kind} (block curve {app.block_kind}): end to end "
            f"{1e3 * statistics.median(walls) / K_MAIN:.4f} ms, fused kernels "
            f"{k_ms:.4f} ms")
    # the block curve itself, same state: three passes in alternating
    # order, so that the curves' differences stand beside the spread of
    # one curve's readings
    curve_runs = {}
    for kind in KINDS:
        pipe = ResidentPipeline(M=M_MAIN, T=T_MAIN, g=G_MAIN, kind=kind,
                                S=S_MAIN, device=dev)
        curve_runs[kind] = (pipe.run_fn(K_MAIN), pipe.to_blocks(cube))
    curve_ms = {kind: [] for kind in KINDS}
    for pass_ in range(3):
        for kind in KINDS if pass_ % 2 == 0 else KINDS[::-1]:
            run, st = curve_runs[kind]
            curve_ms[kind].append(cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN)
    for kind, ms in curve_ms.items():
        log(f"block curve {kind}: fused kernels "
            + ", ".join(f"{t:.4f}" for t in ms) + " ms/timestep (three passes)")
    means = {kind: statistics.mean(ms) for kind, ms in curve_ms.items()}
    between = max(means.values()) - min(means.values())
    within = max(max(ms) - min(ms) for ms in curve_ms.values())
    log(f"block curve: the curves' means differ by at most {between:.4f} "
        f"ms/timestep ({100 * between / min(means.values()):.2f}%; fastest "
        f"{min(means, key=means.get)}), one curve's passes by at most "
        f"{within:.4f} ({100 * within / min(means.values()):.2f}%)")
    del curve_runs
    ts_ms = {}
    for T_, S_ in ((8, 1), (8, 2), (8, 4), (16, 1), (16, 2), (16, 4)):
        pipe = ResidentPipeline(M=M_MAIN, T=T_, g=G_MAIN, kind="hilbert", S=S_,
                                device=dev)
        st = pipe.to_blocks(cube)
        run = pipe.run_fn(K_MAIN)
        ts_ms[T_, S_] = k_ms = cuda_ms(lambda: run(st), reps=5, inner=1) / K_MAIN
        o_ = torch.empty_like(st)
        nbr_t = neighbor_table_device("hilbert", M_MAIN // T_, device=dev)
        forced = {ov: cuda_ms(lambda: K._fused_on_card(
            "sm90", st, w1, nbr_t, None, o_, nbr_t.shape[0], g=G_MAIN, S=S_,
            rule="gol", bc=periodic, overlap=ov), reps=5, inner=3) / S_
            for ov in (False, True)}
        log(f"T={T_} S={S_}: fused kernels {k_ms:.4f} ms/timestep "
            f"({K.fused_design(T_, G_MAIN, S_, 1, cube=True)} design; one launch "
            f"of the block design forced "
            f"without overlap {forced[False]:.4f}, with {forced[True]:.4f} "
            f"ms/timestep), modelled "
            f"{pipe.bytes_per_step(K_MAIN) / 1e6:.1f} MB/timestep, "
            f"shared memory {pipe.smem_bytes()} B per thread block in plan()'s "
            f"model, {K.sm90_smem_bytes(T_, G_MAIN, S_)} in the Hopper design")
    plan = ResidentPipeline.plan(M_MAIN, g=G_MAIN, kind="hilbert", n_steps=K_MAIN,
                                 device=dev)
    best = min(ts_ms, key=ts_ms.get)
    picked = ts_ms.get((plan.T, plan.S))
    log(f"plan() picks T={plan.T} S={plan.S} ("
        + ("not measured" if picked is None else f"{picked:.4f} ms/timestep")
        + f"); fastest measured T={best[0]} S={best[1]} ({ts_ms[best]:.4f})")
    st = wave.to_blocks(fields)
    run = wave.run_fn(8)
    log(f"wave C=2 S=2 neumann0: fused kernels "
        f"{cuda_ms(lambda: run(st), reps=5, inner=1) / 8:.4f} ms/timestep")

    # the distributed path per mesh and ordering: end to end (host clock
    # around run_distributed, with its sharding and ordering gathers), the
    # pipeline's rounds alone, and one round split into its exchange
    # (pack; then shift, unpack, edge assembly and shell scatter) and its
    # fused kernels, each timed on its own with CUDA events
    for shape, mesh in meshes.items():
        tag = "x".join(map(str, shape))
        for spec in CHIP_ORDERINGS:
            app = Gol3d(dataclasses.replace(CHIP_DISTRIBUTED, ordering=spec))
            app.run_distributed(mesh, K_D)
            sync()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                app.run_distributed(mesh, K_D)
                sync()
                walls.append(time.perf_counter() - t1)
            pipe = app.distributed_pipeline(mesh)
            st = shard_state(app.cube, spec, pipe.procs)
            shards = [st[co] for co in mesh.shards]
            run = pipe.run_fn(K_D)
            run_ms = cuda_ms(lambda: run(shards), reps=5, inner=1) / K_D
            kind, M_l, T_l, h = pipe.kind, pipe.M, pipe.T, pipe.S * pipe.g
            nt_l = M_l // T_l
            nb_l = nt_l ** 3
            exts = [extended_store(to_store(x, spec, kind, T_l, M_l), nt_l)
                    for x in shards]
            outs = [core_of(torch.zeros_like(e), nb_l) for e in exts]
            flats = [core_of(e, nb_l).reshape(-1) for e in exts]
            hspec = store_spec(kind, T_l)
            nbr_l = extended_neighbor_table_device(kind, nt_l, dev)
            pack = lambda: [kops.pack_surface(f, hspec, M_l, h, face)
                            for f in flats for face in FACES]
            fill = lambda: fill_shells(mesh, exts, kind=kind, M=M_l, h=h,
                                       bc=pipe.bc)
            check(not pipe.bc.clamped, "the timed round assumes periodic")
            fused = lambda: [K.stencil_step_fused(e, w1, nbr_l, g=G_MAIN,
                                                  S=pipe.S, rule=pipe.rule,
                                                  out=o)
                             for e, o in zip(exts, outs)]
            p_ms, f_ms, k_ms = (cuda_ms(fn, reps=5, inner=3)
                                for fn in (pack, fill, fused))
            log(f"distributed {tag} {spec.name} (block curve {kind}, local "
                f"M={M_l}): end to end {1e3 * statistics.median(walls) / K_D:.4f} "
                f"ms/timestep, rounds {run_ms:.4f} ms/timestep; one round: "
                f"exchange {f_ms:.4f} ms (pack {p_ms:.4f}, shift+unpack+scatter "
                f"{f_ms - p_ms:.4f}), fused {k_ms:.4f} ms, exchange share "
                f"{100 * f_ms / (f_ms + k_ms):.1f}%")
        log(f"model {tag}: distributed {pipe.bytes_per_step(K_D) / 1e6:.3f} "
            f"MB/timestep per shard, of which exchange "
            f"{pipe.exchange_bytes_per_step() / 1e6:.3f} MB/timestep "
            f"({pipe.exchange_bytes_per_step() * pipe.S / 4:.0f} items per "
            f"exchange)")

    # the paper's exchange question on this card: pack the six width-g
    # faces of a path-ordered M=256 cube under each ordering; rows of 64
    # fetched (the device-memory traffic of the pack), ms per call and
    # device ms (the gather kernel and the element selection) per face
    for spec in CHIP_ORDERINGS:
        path = apply_ordering(cube_d, spec)
        for g_p in (1, 4):
            parts = []
            for face in FACES:
                idx = surface_path_indices(spec, M_D, g_p, face)
                rows, _ = kops._row_plan(idx, LINE, (spec, M_D, g_p, face))
                rs = run_stats(spec, M_D, g_p, face)
                pk = lambda: kops.pack_surface(path, spec, M_D, g_p, face)
                d_ms, how = device_ms(pk, n=50)
                parts.append(f"{face} {len(rows)} rows {rs.n_runs} runs "
                             f"{cuda_ms(pk, inner=20):.4f} ms per call, "
                             f"{d_ms:.4f} ms {how}")
            log(f"pack {spec.name} g={g_p}: " + "; ".join(parts))

    # smollm-360m end to end: prefill with the kernel and with plain
    # attention, and decode; host clock around work ending in a
    # synchronize, median of 5 after a warm-up
    pf_ms = walls_ms(lambda: lm.prefill(batch))
    pp_ms = walls_ms(lambda: tfm.prefill(lm.params(), batch, plain_cfg), n=3)
    dec_ms = walls_ms(lambda: greedy_decode(lm, prompts, N_D, P_D + N_D + 1))
    steps = P_D + N_D - 1
    log(f"{lm_cfg.name} prefill B={B_P} S={S_P}: {pf_ms:.3f} ms "
        f"({B_P * S_P / pf_ms * 1e3:.0f} tokens/s) with flash_attention_fwd, "
        f"{pp_ms:.3f} ms ({B_P * S_P / pp_ms * 1e3:.0f} tokens/s) with plain "
        f"attention; greedy_decode {B_D}x{N_D} after {P_D}-token prompts: "
        f"{dec_ms:.3f} ms, {dec_ms / steps:.3f} ms per step ({steps} steps), "
        f"{B_D * N_D / dec_ms * 1e3:.1f} new tokens/s")

    sync()
    log(f"timings ({time.perf_counter() - t0:.1f} s)")

    # where the time of one main-path run goes, by kernel (profiler on)
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn, what, top=8):
        """One call of fn under the profiler, device activity only (a
        trace of the host's ops too took 80 s to aggregate over a
        greedy_decode's 47 steps), read by ``device_ms_by_name``: wall,
        device busy, the top kernels."""
        fn()
        sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            fn()
            sync()
            wall_ms = 1e3 * (time.perf_counter() - t1)
        by_name = device_ms_by_name(prof)
        if not by_name:
            log(f"profile {what}: the profiler recorded no device time "
                "(not measured)")
            return by_name
        busy = sum(by_name.values())
        log(f"profile {what}, profiler on: wall {wall_ms:.3f} ms, device busy "
            f"{busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            log(f"  {ms:.4f} ms  {name[:100]}")
        return by_name

    app = apps["hilbert"]
    profiled(lambda: app.run_resident(K_MAIN), f"run_resident({K_MAIN}) hilbert")
    profiled(lambda: rep_app.run(CHIP_REPACK_STEPS),
             f"repack run({CHIP_REPACK_STEPS}) M={CHIP_REPACK.M}", top=10)
    app = Gol3d(CHIP_DISTRIBUTED)
    for shape, mesh in meshes.items():
        profiled(lambda: app.run_distributed(mesh, K_D),
                 f"run_distributed({K_D}) {CHIP_DISTRIBUTED.ordering.name} "
                 f"{'x'.join(map(str, shape))}", top=12)

    by_name = profiled(lambda: lm.prefill(batch),
                       f"{lm_cfg.name} prefill B={B_P} S={S_P}", top=10)
    if by_name:
        fa_ms = sum(ms for name, ms in by_name.items() if "flash_fwd" in name)
        log(f"flash_attention_fwd share of the prefill's device time: "
            f"{fa_ms:.3f} of {sum(by_name.values()):.3f} ms "
            f"({100 * fa_ms / sum(by_name.values()):.1f}%)")
    profiled(lambda: greedy_decode(lm, prompts, N_D, P_D + N_D + 1),
             f"{lm_cfg.name} greedy_decode {B_D}x{N_D}", top=6)

    # the training path (its own launches counted, added to the kernel's)
    del lm
    torch.cuda.empty_cache()
    tr = train_phase(dev, flash_err, background["train_cli"])
    flash_row = next(k for k in kernels if k["name"] == "flash_attention_fwd")
    flash_row["launches"] += tr["launches"]
    flash_row["training"] = tr["training"]
    bwd_row = dict(name="flash_attention_bwd", route="cuda",
                   source=SOURCES["flash_attention_bwd"],
                   replaces=REPLACES["flash_attention_bwd"],
                   launches=tr["bwd_launches"], **tr["bwd"])
    kernels.append(bwd_row)

    # the training path over a device mesh (its launches counted, added)
    torch.cuda.empty_cache()
    me = mesh_phase(dev, tr["training"], background)
    flash_row["launches"] += me["launches"]
    bwd_row["launches"] += me["bwd_launches"]
    flash_row["mesh"] = me["mesh"]
    flash_row["dryrun"] = me["dryrun"]

    # the other decoder LMs (their prefills' launches counted, added)
    ar = archs_phase(dev, flash_err)
    flash_row["launches"] += ar["launches"]
    flash_row["archs"] = ar["archs"]

    # the examples' torch twins (their launches counted, added)
    torch.cuda.empty_cache()
    for twin, counts in examples_phase(dev).items():
        for name, n in counts.items():
            row = next(k for k in kernels if k["name"] == name)
            row["launches"] += n
            row.setdefault("examples", {})[twin] = n

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: kern[k] for k in keys},
                                   **{k: v for k, v in kern.items() if k not in keys}}
                                  for kern in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
