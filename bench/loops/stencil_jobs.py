"""A closed loop of stencil jobs with one job in flight.

A job is ``ResidentPipeline.run(state, steps_per_job)``: the curve
blockize of the (C, M, M, M) state, the fused launches, the unblockize.
Its output is the next job's input, and each job ends in a synchronise
(the user reads the field back every ``steps_per_job`` steps).

Traffic keys: ``block_order`` (the pipeline's ``kind``),
``steps_per_job``, ``init_range`` (the fields are uniform in it, drawn
from the seed on the device), ``check_jobs`` (jobs compared besides the
first and the last, drawn from the seed), ``limits`` (``max_abs_diff``:
the largest difference of any site from the reference, over the jobs
compared).

The comparison: the first job from the benchmark's own initial state,
and the others from the state the program handed them (the program's
own output of the job before), each run again by the plain reference
(``bench/reference/wave.py``) for ``steps_per_job`` steps.
"""

from __future__ import annotations

import random
import time

import torch

from bench.harness import Check, Unit, log


class Loop:
    def __init__(self, cell, seed, device, sync):
        self.cell, self.seed, self.device, self.sync = cell, seed, device, sync
        c, t = cell.config, cell.traffic
        self.M, self.T, self.g, self.S = c["M"], c["T"], c["g"], c["S"]
        self.rule, self.C = c["rule"], c["channels"]
        self.steps = t["steps_per_job"]
        self.kept: list[tuple[int, torch.Tensor, torch.Tensor]] = []

    def setup(self):
        c, t = self.cell.config, self.cell.traffic
        if c["dtype"] != "float32":
            raise ValueError(f"stencil_jobs runs float32 stores, not {c['dtype']}")
        self.state0 = self.initial_state()
        self.pipe = self.pipeline()
        log("stencil: state made, pipeline built")
        if self.pipe.channels != self.C:
            raise ValueError(f"rule {self.rule} has {self.pipe.channels} channels, "
                             f"the configuration says {self.C}")
        # the one shape the traffic uses: a whole job
        self.pipe.run(self.state0, self.steps)
        self.sync()
        log("stencil: one job warmed")

    def initial_state(self) -> torch.Tensor:
        """The (C, M, M, M) float32 fields, uniform in ``init_range``, drawn
        from the seed on the device."""
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        lo, hi = self.cell.traffic["init_range"]
        x = torch.rand((self.C,) + (self.M,) * 3, generator=gen, device=self.device)
        return x.mul_(hi - lo).add_(lo)

    def pipeline(self):
        from repro_torch.stencil.pipeline import ResidentPipeline

        return ResidentPipeline(M=self.M, T=self.T, g=self.g,
                                kind=self.cell.traffic["block_order"], S=self.S,
                                rule=self.rule, bc=self.cell.config["boundary"],
                                device=self.device)

    def window(self, seconds: float):
        rng = random.Random(self.seed)
        self.kept = []
        k = self.cell.traffic["check_jobs"]
        sample: list[tuple[int, torch.Tensor, torch.Tensor]] = []
        units, first, last = [], None, None
        work = {"site_updates": self.M ** 3 * self.steps,
                "flops": self.M ** 3 * self.steps * self.flops_per_site()}
        x = self.state0
        t0 = time.perf_counter()
        i = 0
        while True:
            ts = time.perf_counter()
            with torch.profiler.record_function("bench.job"):
                y = self.pipe.run(x, self.steps)
                self.sync()
            te = time.perf_counter()
            units.append(Unit(ts, te, work))
            pair = (i, x, y)
            if i == 0:
                first = pair
            elif len(sample) < k:
                sample.append(pair)
            else:
                j = rng.randrange(i)
                if j < k:
                    sample[j] = pair
            last = pair
            x = y
            i += 1
            if te - t0 >= seconds:
                break
        self.kept = sorted({p[0]: p for p in [first, *sample, last]}.values(),
                           key=lambda p: p[0])
        return units

    def flops_per_site(self) -> int:
        from bench import work

        return work.stencil_flops_per_site(self.g, self.rule)

    def release(self):
        del self.pipe, self.state0

    def expected_designs(self, launches: dict) -> dict:
        d = launches["STENCIL_DESIGN_LAUNCHES"]
        return {"fused launches by design": d, "sm90 only": d.get("simple", 0) == 0
                and d.get("sm90", 0) > 0}

    def check(self):
        from bench.reference.wave import wave_run

        if self.rule != "wave" or self.cell.config["boundary"] != "periodic":
            raise ValueError("the reference runs the periodic wave rule only")
        worst = 0.0
        for _, inp, out in self.kept:
            ref = wave_run(inp, self.steps, self.g)
            d = (out.float() - ref).abs()
            d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
            worst = max(worst, float(d.max()))
            del ref, d
        return [Check("max_abs_diff", worst,
                      self.cell.traffic["limits"]["max_abs_diff"])]

    def control(self):
        """The program with a bfloat16 store (its own path for a store
        below float32) from the same initial state, one job, against the
        float32 reference."""
        from bench.reference.wave import wave_run

        x = self.initial_state()
        out = self.pipeline().run(x.to(torch.bfloat16), self.steps)
        d = (out.float() - wave_run(x, self.steps, self.g)).abs()
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        return [Check("max_abs_diff", float(d.max()),
                      self.cell.traffic["limits"]["max_abs_diff"])]
