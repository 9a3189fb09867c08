"""Model FLOPs of the window's units over the traced window x 67 TFLOP/s
x cards (benchlib/readers.py: mfu)."""

from benchlib.readers import mfu as read  # noqa: F401
