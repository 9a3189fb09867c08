"""Host ms per photo in the program's ``model.decompress`` spans
(``LargeResNetVAE.decompress``: the canonical decode the residual is
scored against) (benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "model.decompress")
