"""Host ms per step in the program's ``train.optimizer`` and ``train.ema``
spans (``optimizer.update``, ``ema_update``) (benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "train.optimizer", "train.ema")
