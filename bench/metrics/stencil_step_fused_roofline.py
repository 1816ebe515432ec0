"""The fused stencil kernel's share of its roofline, in %: the bound of
one launch (``bench/work.fused_launch_bound_s``) times the launches in
the traced window, over the device time of the fused kernels there
(any design: ``fused_sm90_kernel``, ``fused_kernel``)."""

from bench import work


def read(run):
    launches = run.launches["LAUNCHES"]["stencil_step_fused"]
    busy, events = run.trace.kernel_s(lambda n: "fused" in n and "kernel" in n)
    if not launches or not events or busy <= 0:
        return None
    c = run.cell.config
    bound = work.fused_launch_bound_s(c["M"], c["T"], c["g"], c["S"], c["rule"],
                                      c["channels"])
    return 100.0 * launches * bound / busy
