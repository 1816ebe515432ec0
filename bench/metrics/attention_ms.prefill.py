"""Device ms a request in the attention sublayers outside flash's
wrapper: the program's span ``model.attention`` (norm, projections,
RoPE, output projection, residual) less ``kernels.flash_attention``,
``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.attention", ("kernels.flash_attention",))
