"""Host ms per image in the benchmark's span around the canonical
``model.decompress`` (ended by the copy of its output to the host)."""

from benchlib.readers import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "decode")
