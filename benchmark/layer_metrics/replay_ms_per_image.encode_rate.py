"""Host ms per image in the program's ``coder.replay`` spans
(``coding/beam_search.py::_replay_flat``, encode and decode) of the traced
window (benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "coder.replay")
