"""Seconds of set-up in the program's ``setup.normal_table`` spans (the
build of ``rng.erfinv_table``, under ``rng.normal_table``, once per card,
fenced) (benchlib/program_trace.py)."""

from benchlib.program_trace import setup_s


def read(ctx):
    return setup_s(ctx, "setup.normal_table")
