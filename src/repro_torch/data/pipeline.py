"""Deterministic, seekable synthetic data pipelines.

The torch package's own copy of ``repro.data.pipeline`` (numpy only; the
same arrays for the same arguments):

- ``TokenPipeline``: structured synthetic LM tokens (Zipf unigrams +
  copy/induction spans so a model has something learnable). The batch at
  ``step`` is a pure function of (seed, step) ⇒ restart/elastic restore
  resumes the exact stream by cursor alone, any worker can regenerate any
  shard (no coordination), and stragglers can be re-issued idempotently.
- ``cube_loader``: initial states for gol3d, laid out under any ordering
  (SFC-tiled per DESIGN.md §2).

Both return numpy arrays; the caller puts them on its device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.orderings import ROW_MAJOR, OrderingSpec, path_to_rmo

__all__ = ["TokenPipeline", "cube_loader"]


@dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    induction_frac: float = 0.5  # fraction of sequence that is copied spans

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """Pure function of (seed, step): {tokens, labels} int32."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        B, S, V = self.batch, self.seq + 1, self.vocab
        # Zipf-ish unigram draw (stable, heavy-tailed)
        ranks = np.arange(1, V + 1, dtype=np.float64)
        p = 1.0 / ranks
        p /= p.sum()
        toks = rng.choice(V, size=(B, S), p=p).astype(np.int32)
        # induction spans: copy an earlier window forward
        span = max(4, S // 16)
        n_spans = int(self.induction_frac * S / span / 2)
        for b in range(B):
            for _ in range(n_spans):
                src = rng.integers(0, S - 2 * span)
                dst = rng.integers(src + span, S - span)
                toks[b, dst:dst + span] = toks[b, src:src + span]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def cube_loader(M: int, density: float, seed: int,
                spec: OrderingSpec = ROW_MAJOR) -> np.ndarray:
    """(M³,) initial gol3d state in ``spec`` path order."""
    rng = np.random.default_rng(seed)
    cube = (rng.random((M, M, M)) < density).astype(np.float32)
    q = path_to_rmo(spec, M)
    return cube.reshape(-1)[q]
