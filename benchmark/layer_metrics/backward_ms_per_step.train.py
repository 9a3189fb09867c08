"""Host ms per step in the program's ``train.backward`` spans (the
gradients' ``autograd.grad`` in ``train/lossless.py::_update``)
(benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "train.backward")
