"""Device ms a step inside the program's ``adamw_update`` range
(``train/train_step.py``): the device's busy time within each range's
span on the device's timeline, averaged over the steps traced."""


def read(run):
    busy, n = run.trace.range_busy_s("adamw_update")
    return 1e3 * busy / n if n else None
