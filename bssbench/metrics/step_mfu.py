"""``step_mfu``: the whole call's share of the card's compute peak, in percent.

The floating-point operations a call needs, over the traced calls' wall
time times the TF32 peak (``bssbench/peaks.py``). The count is the
configuration's algorithm's own: ``call_flops(shapes)`` in
``bssbench/reference/<algorithm>.py``, beside the plain version it counts,
so a configuration with a new algorithm brings its count in its own file. A
reference without one is an error, not a silent gap. The share bounds every
kernel's from above: a later change that takes a kernel off the path leaves
that kernel's roofline unread, and this one still reads the whole call.
Elementwise work outside the counted products is not counted, so the share
reads low.
"""

from bssbench.peaks import PEAKS


def read(trace, ctx):
    reference = ctx["reference"]
    if not hasattr(reference, "call_flops"):
        raise AttributeError(f"{reference.__name__} defines no call_flops(shapes): step_mfu has no count for "
                             f"algorithm {ctx['config']['algorithm']!r}")
    ops = reference.call_flops(ctx["shapes"])
    peak = PEAKS.get(ctx["device_name"])
    if peak is None or not trace.calls:
        return None
    wall = sum(end - start for start, end in trace.calls) * 1e-6
    return 100.0 * ops * len(trace.calls) / (wall * peak["flops"])
