"""Tokens a second: the tokens of every training step completed in the
window, over the window's host-clock seconds."""


def read(run):
    return run.total("tokens") / run.window_s
