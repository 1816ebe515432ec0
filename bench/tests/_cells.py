"""The benchmark's cells at a size a CPU test holds: the committed
configuration and traffic files with their scale cut, every other key
(limits, orders, optimizer) as committed.

The LM runs in float32 activations here, so that a sound run of the
program sits at float32 rounding from the reference. The prefill cell's
model has an untied head and weights ten times wider: in a model of two
layers and 64 wide, a tied head puts the prompt's last token first by a
wide margin and fp8's rounding never moves it, while the committed
limit on the served token's logit gap is absolute (set at the cell's
size, where fp8 reads 0.1-0.2)."""

from __future__ import annotations

from bench import harness

TINY_LM = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
               d_ff=128, vocab=512, activation_dtype="float32")
TINY = {
    "wave-m256.hilbert": (dict(M=16), dict(steps_per_job=8)),
    "wave-m256.row-major": (dict(M=16), dict(steps_per_job=8)),
    "smollm-360m.train-4k": (TINY_LM, dict(batch=2, seq=128)),
    "smollm-360m.prefill-long": (dict(TINY_LM, vocab=4096, tie_embeddings=False,
                                      initializer_range=0.2),
                                 dict(lengths={"128": 2, "256": 1}, token_pool=4096,
                                      check_requests=32)),
}


def tiny_cell(name: str, **config) -> harness.Cell:
    cell = harness.resolve(name)
    cfg, traffic = TINY[name]
    cell.config.update(cfg, **config)
    cell.traffic.update(traffic)
    return cell
