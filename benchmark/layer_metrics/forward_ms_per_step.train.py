"""Host ms per step in the program's ``train.forward`` spans (``objective``
in ``train/lossless.py``) (benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "train.forward")
