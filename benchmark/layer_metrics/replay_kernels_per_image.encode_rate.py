"""Device kernels per image (copies left out) attributed to the program's
``coder.replay`` spans and the spans inside them, by the card and the start
of each kernel (benchlib/program_trace.py)."""

from benchlib.program_trace import kernels_per_unit


def read(ctx):
    return kernels_per_unit(ctx, "coder.replay")
