"""Seconds of set-up in the program's ``setup.ddi`` span
(``BidirectionalResNetVAE.data_dependent_init``, fenced)
(benchlib/program_trace.py)."""

from benchlib.program_trace import setup_s


def read(ctx):
    return setup_s(ctx, "setup.ddi")
