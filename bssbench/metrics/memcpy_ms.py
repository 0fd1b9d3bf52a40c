"""``memcpy_ms``: device time of the host-to-device and device-to-host copies, per call."""


def read(trace, ctx):
    per_call = trace.in_calls(("memcpy",))
    copies = [d for events in per_call for d in events if "HtoD" in d.name or "DtoH" in d.name]
    if not copies:
        return None
    return sum(d.end - d.start for d in copies) * 1e-3 / len(per_call)
