"""``device_idle``: the share of the traced calls' window in which no kernel, copy or memset runs, in percent."""

from bssbench.tracing import busy_us


def read(trace, ctx):
    if not trace.calls or not trace.device:
        return None
    lo, hi = trace.window
    return 100.0 * (1.0 - busy_us(trace) / (hi - lo))
