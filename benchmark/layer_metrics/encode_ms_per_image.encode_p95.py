"""Host ms per photo in the program's ``model.compress`` spans
(``LargeResNetVAE.compress``: the inference pass and both groups' coded
generative pass) (benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "model.compress")
