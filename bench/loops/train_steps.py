"""Back-to-back training steps.

One object, the step of ``make_train_step`` with its model and AdamW
state, is built from the seed and driven through its first
``compared_steps`` steps in set-up, then through the window: step i
takes ``TokenPipeline(seed).batch_at(i)``, made on the host inside the
window while the device runs step i-1 (a loader that prefetches one
batch) and copied to the device, and the loss is read back after every
step, as a training loop logs it. The window's last step is the one
that would end past ``--seconds`` by the mean step so far; before it the
loop keeps a copy of the parameters, AdamW's state and the batch on the
device (the program's peak is read before that copy is taken).

Traffic keys: ``batch``, ``seq``, ``microbatches``, ``remat``,
``optimizer`` (``OptConfig``'s fields), ``compared_steps``,
``grad_floor`` (a leaf whose reference gradient is under this share of
the median leaf's is left out of a change's comparison: it moves by
round-off alone), and ``limits``:

- ``loss_rel``: the mean relative gap of the compared steps' losses
  (the set-up steps and the window's last step);
- ``grad_norm_gap``: the first step's clipped gradient, as the optimizer
  applies it (the program's worked out from its first moment after one
  step, m / (1 - b1)), by the worst leaf: the gap between the program's
  norm and the reference's over the larger of the reference's norm of
  that leaf and of the median leaf;
- ``change_gap``: the same of each leaf's change over the set-up steps;
- ``window_change_gap``: the same of each leaf's change in the window's
  last step, which the reference takes from the copy kept before it.

The window's last step's clipped gradient ((m' - b1·m) / (1 - b1)) is
logged beside the reference's, not compared: under clipping it follows
the global norm, which rounding moves by up to a few percent there.

The reference (``bench/reference/lm.py``) runs the same steps in
float32 from the same weights and batches once the window has closed;
for the window's last step it follows the program's own state.
"""

from __future__ import annotations

import statistics
import time

import torch

from bench.loops import _lm
from bench.harness import Check, Unit, log


def _gap(prog: dict, ref: dict, names, what: str) -> float:
    """The worst leaf's gap of norms over the larger of its reference norm
    and the median leaf's; the three worst leaves go to the log."""
    med = statistics.median(ref[n] for n in names)
    gaps = {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:3]
    log(f"{what}: worst leaves " + ", ".join(
        f"{n} {gaps[n]:.3g} (norm {prog[n]:.6g} against {ref[n]:.6g})" for n in worst))
    return gaps[worst[0]]


class Loop:
    def __init__(self, cell, seed, device, sync):
        self.cell, self.seed, self.device, self.sync = cell, seed, device, sync
        t = cell.traffic
        self.B, self.S = t["batch"], t["seq"]
        self.n_first = t["compared_steps"]

    def batch(self, i: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.pipe.batch_at(i).items()}

    def setup(self):
        from repro_torch.data import TokenPipeline
        from repro_torch.models.params import leaf_paths
        from repro_torch.train import (OptConfig, TrainConfig, init_opt_state,
                                       make_train_step)

        c, t = self.cell.config, self.cell.traffic
        log("train: program imported")
        w0 = _lm.make_weights(c, self.seed, self.device)
        self.model = _lm.load_model(c, w0, self.device).requires_grad_()
        log("train: weights made and loaded")
        self.params = self.model.params()
        self.state = init_opt_state(self.params)
        self.opt = t["optimizer"]
        self.step = make_train_step(self.model, TrainConfig(
            opt=OptConfig(**self.opt), microbatches=t["microbatches"],
            remat=t["remat"]))
        self.pipe = TokenPipeline(vocab=c["vocab"], batch=self.B, seq=self.S,
                                  seed=self.seed)
        # the first steps: the warm-up of every shape, and what the
        # reference follows
        self.losses = []
        for i in range(self.n_first):
            start = time.perf_counter()
            _, self.state, m = self.step(self.params, self.state, self.batch(i))
            self.losses.append(float(m["loss"]))
            self.step_s = time.perf_counter() - start
            log(f"train: step {i} (loss {self.losses[-1]:.6f})")
            if i == 0:
                self.grad_norms = {".".join(p): float(x.norm()) / (1 - self.opt["b1"])
                                   for p, x in leaf_paths(self.state["m"])}
        self.changes = {".".join(p): float((x.detach() - w0[".".join(p)]).norm())
                        for p, x in leaf_paths(self.params)}
        del w0
        self.next_step = self.n_first
        self.snap = None

    def window(self, seconds: float):
        from bench import work

        units = []
        tokens = self.B * self.S
        flops = work.lm_train_flops(self.cell.config, self.B, self.S)
        self.snap = None
        t0 = time.perf_counter()
        batch = self.batch(self.next_step)
        while True:
            ts = time.perf_counter()
            mean = (ts - t0) / len(units) if units else self.step_s
            last = ts - t0 + mean >= seconds
            if last:
                with torch.profiler.record_function("bench.keep_state"):
                    self.keep_state(batch)
            with torch.profiler.record_function("bench.step"):
                _, self.state, m = self.step(self.params, self.state, batch)
            # the next batch is made on the host while the device runs this
            # step, as a loader that prefetches one batch makes it
            if not last:
                with torch.profiler.record_function("bench.feed"):
                    host = self.pipe.batch_at(self.next_step + 1)
            with torch.profiler.record_function("bench.readback"):
                loss = float(m["loss"])
            te = time.perf_counter()
            if loss != loss:
                raise FloatingPointError(f"step {self.next_step}: loss is NaN")
            units.append(Unit(ts, te, {"tokens": tokens, "flops": flops}))
            self.next_step += 1
            if last:
                self.snap["loss"] = loss
                self.snap["grad_norm"] = float(m["grad_norm"])
                return units
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in host.items()}

    def keep_state(self, batch: dict):
        """A copy of the parameters and AdamW's moments before step
        ``next_step``, its batch and index, on the device; the program's
        peak is read first."""
        from repro_torch.models.params import leaf_paths

        self.program_peak = (torch.cuda.max_memory_allocated(self.device)
                             if self.device.type == "cuda" else 0)

        def copy(tree):
            return {".".join(p): x.detach().clone() for p, x in leaf_paths(tree)}

        self.snap = {"step": self.next_step, "batch": batch, "params": copy(self.params),
                     "m": copy(self.state["m"]), "v": copy(self.state["v"])}

    def release(self):
        """What the check reads of the window's last step (the program's
        state after it against the copy before), then the program goes."""
        from repro_torch.models.params import leaf_paths

        s, b1 = self.snap, self.opt["b1"]
        m_after = {".".join(p): x for p, x in leaf_paths(self.state["m"])}
        self.window_step = {
            "loss": s["loss"],
            "grad_norms": {n: float(((x.detach() - b1 * s["m"][n]) / (1 - b1)).norm())
                           for n, x in m_after.items()},
            "changes": {".".join(p): float((x.detach() - s["params"][".".join(p)]).norm())
                        for p, x in leaf_paths(self.params)}}
        del self.step, self.state, self.params, self.model

    def expected_designs(self, launches: dict) -> dict:
        return _lm.flash_designs(launches, backward=True)

    def reference_steps(self, gemm_dtype=None) -> dict:
        """The reference's compared steps from the same weights and
        batches: each step's loss, the first step's clipped gradient norm
        and each leaf's change over the steps, by leaf name."""
        from bench.reference.lm import Ref, adamw_step

        w = _lm.make_weights(self.cell.config, self.seed, self.device)
        w0 = {n: t.clone() for n, t in w.items()}
        ref = Ref(self.cell.config, w, gemm_dtype)
        state: dict = {}
        losses = []
        for i in range(self.n_first):
            b = self.pipe.batch_at(i)
            loss, grads = ref.loss_and_grads(
                torch.from_numpy(b["tokens"]).to(self.device),
                torch.from_numpy(b["labels"]).to(self.device))
            losses.append(loss)
            clipped = adamw_step(w, grads, state, i, self.opt)
            if i == 0:
                first = {n: float(g.norm()) for n, g in clipped.items()}
            del grads, clipped
        changes = {n: float((w[n] - w0[n]).norm()) for n in w}
        return {"losses": losses, "grad_norms": first, "changes": changes}

    def reference_window_step(self, gemm_dtype=None) -> dict:
        """The reference's window's last step from the copy kept before
        it: its loss, clipped gradient norms and changes, by leaf name."""
        from bench.reference.lm import Ref, adamw_step

        s = self.snap
        w = {n: t.clone() for n, t in s["params"].items()}
        ref = Ref(self.cell.config, w, gemm_dtype)
        loss, grads = ref.loss_and_grads(s["batch"]["tokens"], s["batch"]["labels"])
        state = {(k, n): s[k][n].clone() for k in ("m", "v") for n in w}
        clipped = adamw_step(w, grads, state, s["step"], self.opt)
        gn = sum(float((g.double() ** 2).sum()) for g in grads.values()) ** 0.5
        log(f"window step {s['step']}: global gradient norm {s.get('grad_norm', 0.0):.6g} "
            f"(program) against {gn:.6g}{' (control)' if gemm_dtype else ''}")
        out = {"loss": loss, "grad_norms": {n: float(g.norm()) for n, g in clipped.items()},
               "changes": {n: float((w[n] - s["params"][n]).norm()) for n in w}}
        del w, grads, state, clipped
        return out

    def _moved(self, ref: dict) -> list:
        """The leaves whose reference gradient reaches the gradient floor."""
        med = statistics.median(ref["grad_norms"].values())
        return sorted(n for n, g in ref["grad_norms"].items()
                      if g >= self.cell.traffic["grad_floor"] * med)

    def compare(self, got: dict, ref: dict, window: dict, ref_window: dict) -> list:
        """The numbers of ``got`` (the set-up steps) and ``window`` (the
        window's last step) against the reference's ``ref`` and
        ``ref_window``."""
        lim = self.cell.traffic["limits"]
        losses = got["losses"] + [window["loss"]]
        ref_losses = ref["losses"] + [ref_window["loss"]]
        gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
        log(f"losses {losses} against {ref_losses}: relative gaps {gaps}")
        names = sorted(ref["grad_norms"])
        _gap(window["grad_norms"], ref_window["grad_norms"], names,
             "window step's gradient (not compared)")
        return [Check("loss_rel", sum(gaps) / len(gaps), lim["loss_rel"]),
                Check("grad_norm_gap", _gap(got["grad_norms"], ref["grad_norms"], names,
                                             "first gradient"), lim["grad_norm_gap"]),
                Check("change_gap", _gap(got["changes"], ref["changes"], self._moved(ref),
                                         "change"), lim["change_gap"]),
                Check("window_change_gap",
                      _gap(window["changes"], ref_window["changes"],
                           self._moved(ref_window), "window step's change"),
                      lim["window_change_gap"])]

    def check(self):
        self.reference = self.reference_steps()
        self.reference_window = self.reference_window_step()
        got = {"losses": self.losses, "grad_norms": self.grad_norms,
               "changes": self.changes}
        return self.compare(got, self.reference, self.window_step, self.reference_window)

    def control(self):
        """The reference in fp8 products in the program's place, against
        the float32 reference (after :meth:`check`)."""
        low = torch.float8_e4m3fn
        return self.compare(self.reference_steps(low), self.reference,
                            self.reference_window_step(low), self.reference_window)
