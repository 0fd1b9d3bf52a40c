"""``device_ms_per_iter``: the kernels' time of a call over its iterations, as a mean over the traced calls."""


def read(trace, ctx):
    per_call = trace.in_calls(("kernel",))
    total = sum(d.end - d.start for events in per_call for d in events)
    if not per_call or not total:
        return None
    return total * 1e-3 / len(per_call) / ctx["shapes"]["n_iter"]
