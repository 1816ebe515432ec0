"""A closed loop of one client sending prompts for their first token.

Each request is ``Model.prefill`` of one prompt (batch 1) followed by the
greedy first token, read back to the host; its latency runs from the
request's start to that token on the host. The next request starts when
it has come.

Traffic keys: ``source`` (where the lengths come from), ``lengths``
(prompt length -> its count in one cycle of requests; every cycle holds
the same lengths, in an order drawn from the seed), ``token_pool``
(prompts are slices of one pool of token ids drawn from the seed on the
device, at offsets drawn from the seed), ``check_requests`` (the
requests compared: the first served of every length, and the rest drawn
from the seed among those completed), and ``limits`` (``logit_gap``:
over the requests compared, the widest gap by which the served token's
logit lies below the reference's best, in the reference's float32
logits).
"""

from __future__ import annotations

import random
import time

import torch

from bench.loops import _lm
from bench.harness import Check, Unit, log


class Loop:
    def __init__(self, cell, seed, device, sync):
        self.cell, self.seed, self.device, self.sync = cell, seed, device, sync
        t = cell.traffic
        self.lengths = sorted(int(k) for k in t["lengths"])
        self.cycle = [L for L in self.lengths for _ in range(t["lengths"][str(L)])]

    def setup(self):
        c, t = self.cell.config, self.cell.traffic
        w = _lm.make_weights(c, self.seed, self.device)
        self.model = _lm.load_model(c, w, self.device)
        del w
        log("prefill: weights made and loaded")
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.pool = torch.randint(c["vocab"], (t["token_pool"],), generator=gen,
                                  device=self.device)
        # the shapes the traffic uses: one prompt of each length
        for L in self.lengths:
            self.serve(0, L)
            log(f"prefill: warmed {L} tokens")
        self.sync()

    def serve(self, offset: int, L: int) -> int:
        logits = self.model.prefill({"tokens": self.pool[offset:offset + L][None]})
        return int(torch.argmax(logits[0]))

    def window(self, seconds: float):
        rng = random.Random(self.seed)
        pool = self.cell.traffic["token_pool"]
        units, order = [], []
        t0 = time.perf_counter()
        while True:
            if not order:
                order = rng.sample(self.cycle, len(self.cycle))
            L = order.pop()
            off = rng.randrange(pool - L + 1)
            ts = time.perf_counter()
            with torch.profiler.record_function("bench.request"):
                tok = self.serve(off, L)
            te = time.perf_counter()
            units.append(Unit(ts, te, {"tokens": L, "offset": off, "served": tok,
                                       "flops": self.flops(L)}))
            if te - t0 >= seconds:
                break
        self.units = units
        return units

    def flops(self, L: int) -> float:
        from bench import work

        return work.lm_prefill_flops(self.cell.config, L)

    def release(self):
        del self.model

    def expected_designs(self, launches: dict) -> dict:
        return _lm.flash_designs(launches, backward=False)

    def sample(self) -> list:
        """The requests compared: the first served of every length, and
        others drawn from the seed up to ``check_requests``."""
        units = self.units
        firsts = {}
        for i, u in enumerate(units):
            firsts.setdefault(u.work["tokens"], i)
        rest = sorted(set(range(len(units))) - set(firsts.values()))
        k = max(0, min(self.cell.traffic["check_requests"] - len(firsts), len(rest)))
        picked = random.Random(self.seed + 1).sample(rest, k)
        return [units[i] for i in sorted([*firsts.values(), *picked])]

    def check(self):
        """The widest gap by which a served token's logit lies below the
        float32 reference's best, over the requests compared."""
        from bench.reference.lm import Ref

        ref = Ref(self.cell.config, _lm.make_weights(self.cell.config, self.seed, self.device))
        worst = 0.0
        for u in self.sample():
            t = time.perf_counter()
            logits = ref.last_logits(self.prompt(u))
            gap = float(logits.max() - logits[u.work["served"]])
            worst = max(worst, gap if gap == gap else float("inf"))
            log(f"prefill: request of {u.work['tokens']} tokens compared, gap {gap:.6g} "
                f"({time.perf_counter() - t:.2f} s)")
        return [Check("logit_gap", worst, self.cell.traffic["limits"]["logit_gap"])]

    def prompt(self, u) -> torch.Tensor:
        return self.pool[u.work["offset"]:u.work["offset"] + u.work["tokens"]]

    def control(self):
        """The reference in fp8 products in the program's place, read at
        every position of the same prompts: the widest gap by which the
        token it puts first lies below the float32 reference's best."""
        from bench.reference.lm import Ref

        w = _lm.make_weights(self.cell.config, self.seed, self.device)
        ref, low = Ref(self.cell.config, w), Ref(self.cell.config, w, torch.float8_e4m3fn)
        worst = 0.0
        for u in self.sample():
            toks = self.prompt(u)
            best = ref.logits(toks)
            first = low.logits(toks).argmax(-1, keepdim=True)
            gap = float((best.max(-1).values - best.gather(-1, first)[:, 0]).max())
            worst = max(worst, gap if gap == gap else float("inf"))
            del best, first
        return [Check("logit_gap", worst, self.cell.traffic["limits"]["logit_gap"])]
