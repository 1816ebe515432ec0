"""The mean time to first token, in ms, over every request completed in
the window: from the request's start to its first token on the host."""


def read(run):
    if not run.units:
        return None
    return 1e3 * sum(u.end - u.start for u in run.units) / len(run.units)
