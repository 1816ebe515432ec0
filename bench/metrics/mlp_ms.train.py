"""Device ms a step in the FFN sublayers, forward and backward, outside
remat's recompute: the program's span ``model.mlp`` less
``model.recompute``, ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.mlp", ("model.recompute",))
