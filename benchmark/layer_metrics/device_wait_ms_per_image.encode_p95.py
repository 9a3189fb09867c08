"""Host ms per photo in the program's ``io.to_host`` spans
(``models/lossy/base.py::compress_to_file``: the copies of the indices and
counts to the host, where the host waits for the device's encode)
(benchlib/program_trace.py)."""

from benchlib.program_trace import span_ms_per_unit


def read(ctx):
    return span_ms_per_unit(ctx, "io.to_host")
