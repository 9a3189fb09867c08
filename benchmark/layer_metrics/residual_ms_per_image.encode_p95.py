"""Host ms per photo in the program's ``io.residual`` spans
(``io/residual.py::encode_residual``: the activity classes, the per-class
scale fits and the arithmetic coder, on the host)
(benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "io.residual")
