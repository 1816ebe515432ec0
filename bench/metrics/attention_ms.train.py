"""Device ms a step in the attention sublayers, forward and backward,
outside flash's wrapper and remat's recompute: the program's span
``model.attention`` less ``kernels.flash_attention`` and
``model.recompute``, ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.attention",
                             ("kernels.flash_attention", "model.recompute"))
