"""Share of the traced window with no kernel or copy on the card, mean
over the cards (benchlib/readers.py: device_idle)."""

from benchlib.readers import device_idle as read  # noqa: F401
