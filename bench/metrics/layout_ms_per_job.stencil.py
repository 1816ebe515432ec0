"""Device ms a job spends outside the fused kernel: the curve blockize
and unblockize (``ResidentPipeline.to_blocks`` / ``to_cube``, gathers and
copies of ``core/layout``), in the traced window."""


def read(run):
    if not run.units or not run.trace.device:
        return None
    rest, _ = run.trace.kernel_s(lambda n: not ("fused" in n and "kernel" in n))
    return 1e3 * rest / len(run.units)
