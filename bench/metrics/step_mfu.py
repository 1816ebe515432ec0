"""The whole step's share of the H100's peak in the type of the step's
products (the configuration's ``mfu_dtype``), in %: the model's
operations of every unit completed in the window (``bench/work``), over
the window's host-clock seconds (``step_mfu.<cell kind>``)."""


def read(run):
    return run.mfu_pct(run.cell.config["mfu_dtype"])
