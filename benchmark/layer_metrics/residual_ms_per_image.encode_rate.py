"""Host ms per image in the benchmark's span around ``encode_residual`` and
the container write."""

from benchlib.readers import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "residual")
