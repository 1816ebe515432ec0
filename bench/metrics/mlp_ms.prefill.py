"""Device ms a request in the FFN sublayers: the self time of the
program's span ``model.mlp`` (norm, SwiGLU, residual), ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.mlp")
