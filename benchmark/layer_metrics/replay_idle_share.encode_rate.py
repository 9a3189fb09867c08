"""Each card's idle time inside the program's ``coder.replay`` spans of that
card, over its idle time in the traced window, %; the mean over the cards
(benchlib/program_trace.py)."""

from benchlib.program_trace import idle_share


def read(ctx):
    return idle_share(ctx, "coder.replay")
