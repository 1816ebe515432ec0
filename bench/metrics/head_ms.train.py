"""Device ms a step in the head, forward and backward: the self time of
the program's span ``model.head`` (the final norm, the tied head's f32
logits and the chunked cross-entropy), ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, "model.head")
