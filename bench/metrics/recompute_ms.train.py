"""Device ms a step in remat's recompute: the program's span
``model.recompute`` (each layer's forward rerun in the backward, flash's
forward included), ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.recompute")
