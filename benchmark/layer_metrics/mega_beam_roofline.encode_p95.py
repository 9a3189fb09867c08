"""The beam-search kernel's frozen bound over its device time
(benchlib/readers.py: mega_beam_roofline)."""

from benchlib.readers import mega_beam_roofline as read  # noqa: F401
