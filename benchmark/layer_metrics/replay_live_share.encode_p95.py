"""Share of the replay's drawn and summed rows that are live: the sum of
``live_rows`` (min(count, P) a block) over the sum of ``rows`` (N * P) of the
window's ``coder.replay`` spans, % (benchlib/program_trace.py)."""

from benchlib.program_trace import count_share


def read(ctx):
    return count_share(ctx, "coder.replay", "live_rows", "rows")
