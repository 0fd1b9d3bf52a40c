"""``host_exposed_ms``: per call, its wall time less the union of the card's work inside it, as a mean over the traced calls."""

from statistics import fmean

from bssbench.tracing import covered, union


def read(trace, ctx):
    exposed = []
    for (start, end), events in zip(trace.calls, trace.in_calls()):
        exposed.append((end - start - covered(union([(d.start, d.end) for d in events]), start, end)) * 1e-3)
    return fmean(exposed) if exposed else None
