"""Device kernels per step (copies left out) attributed to the program's
``train.optimizer`` and ``train.ema`` spans, by the card and the start of each
kernel (benchlib/program_trace.py)."""

from benchlib.program_trace import kernels_per_unit


def read(ctx):
    return kernels_per_unit(ctx, "train.optimizer", "train.ema")
