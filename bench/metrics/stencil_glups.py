"""Lattice-site updates a second, in 10^9: M³ times the timesteps of every
job completed in the window, over the window's host-clock seconds."""


def read(run):
    return run.total("site_updates") / run.window_s / 1e9
