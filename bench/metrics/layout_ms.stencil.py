"""Device ms a job in the curve layout: the self time of the program's
spans ``stencil.blockize`` and ``stencil.unblockize`` (the gathers and
copies of ``ResidentPipeline.to_blocks`` / ``to_cube``), ``bench/spans``."""

from bench import spans


def read(run):
    return spans.ms_per_unit(run, ("stencil.blockize", "stencil.unblockize"))
