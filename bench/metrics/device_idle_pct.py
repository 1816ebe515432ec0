"""The share of the traced window, in %, in which no kernel, copy or set
ran on the device (``device_idle_pct.<cell kind>``)."""


def read(run):
    return run.idle_pct()
