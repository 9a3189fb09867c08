"""Device kernels in the traced window per unit, copies left out
(benchlib/readers.py: kernels_per_unit)."""

from benchlib.readers import kernels_per_unit as read  # noqa: F401
