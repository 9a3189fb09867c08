"""What the per-layer readers (``layer_metrics/<metric>.py``) share.  Each
takes the traced run's context: the device events and window, the busy
time per card, the benchmark's spans, the units (images or steps) the
window completed, the FLOPs they need and, for the beam-search kernel, the
counts of each launch.  A reader that finds nothing to read returns None,
and the metric is left out of the line."""

from __future__ import annotations

from . import yardstick

_COPIES = ("Memcpy", "Memset")


def mfu(ctx):
    if not ctx.get("flops"):
        return None
    return yardstick.mfu_percent(ctx["flops"], ctx["window_s"], ctx["cards"])


def device_idle(ctx):
    busy = ctx["busy_ns"]
    window = ctx["window_ns"][1] - ctx["window_ns"][0]
    return 100.0 * (1.0 - sum(busy.values()) / (len(busy) * window))


def kernels_per_unit(ctx):
    n = sum(1 for e in ctx["events"] if not e.name.startswith(_COPIES))
    return n / ctx["units"] if ctx["units"] else None


def mega_beam_roofline(ctx):
    """The frozen bound of every launch in the window, summed, over the
    kernel's device time summed."""
    kernel_ns = sum(e.end_ns - e.start_ns for e in ctx["events"]
                    if "mega_beam" in e.name)
    if not kernel_ns or not ctx.get("launch_counts"):
        return None
    bound_ms = yardstick.launches_bound_ms(ctx["launch_counts"],
                                           ctx["coder"], ctx["rates"])
    return 100.0 * bound_ms / (kernel_ns / 1e6)


def span_ms_per_unit(ctx, name: str):
    total = ctx["spans"].totals_ms().get(name)
    if total is None or not ctx["units"]:
        return None
    return total[0] / ctx["units"]
