"""``launches_per_iter``: the kernels a call runs over its iterations, as a mean over the traced calls."""


def read(trace, ctx):
    per_call = trace.in_calls(("kernel",))
    count = sum(map(len, per_call))
    if not count:
        return None
    return count / len(per_call) / ctx["shapes"]["n_iter"]
