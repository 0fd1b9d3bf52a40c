"""The traced run: a ``torch.profiler`` session over a few whole calls, reduced to plain intervals the metric readers take.

A :class:`Trace` holds, in microseconds on the profiler's one timeline:

- ``calls``: each traced call's host interval, as the harness timed it;
- ``device``: every kernel, copy and memset the card ran, with its kind;
- ``host``: the harness's spans (the call, the entry, the copy to host
  memory), the runtime's calls and any host operation the session
  recorded, which name what the host was doing in a gap of the card;
- ``launches``: the runtime calls inside the calls that put work on the card.

Readers see only this, so a synthetic trace tests them (``tests/``).
"""

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

CALL_SPAN = "bssbench.call"
SPAN_PREFIX = "bssbench."
KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
LAUNCH_WORDS = ("LaunchKernel", "Memcpy", "Memset")

Interval = Tuple[float, float]


@dataclass
class DeviceEvent:
    kind: str  # "kernel", "memcpy" or "memset"
    name: str
    start: float
    end: float


@dataclass
class HostEvent:
    name: str
    start: float
    end: float


@dataclass
class Trace:
    calls: List[Interval]
    device: List[DeviceEvent]
    host: List[HostEvent] = field(default_factory=list)
    launches: int = 0  # runtime calls that launch device work, inside the calls

    @property
    def window(self) -> Interval:
        """From the first traced call's start to the last one's end."""
        return min(s for s, _ in self.calls), max(e for _, e in self.calls)

    def in_calls(self, kinds: Sequence[str] = ("kernel", "memcpy", "memset")) -> List[List[DeviceEvent]]:
        """The device events of ``kinds`` of each call: those whose midpoint lies in its interval."""
        out = [[] for _ in self.calls]
        for event in self.device:
            if event.kind not in kinds:
                continue
            mid = 0.5 * (event.start + event.end)
            for k, (s, e) in enumerate(self.calls):
                if s <= mid <= e:
                    out[k].append(event)
                    break
        return out

    def seen(self) -> int:
        """Device events inside the calls (beside :attr:`launches`, the share the profiler kept)."""
        return sum(map(len, self.in_calls()))


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The intervals merged where they touch or overlap, in order."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def covered(merged: Sequence[Interval], lo: float, hi: float) -> float:
    """How much of ``[lo, hi]`` the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


def gaps(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``[lo, hi]`` the merged intervals leave free."""
    out, at = [], lo
    for s, e in merged:
        if e <= lo or s >= hi:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def busy_us(trace: Trace) -> float:
    """Microseconds of the traced window in which any kernel, copy or memset ran."""
    lo, hi = trace.window
    return covered(union([(d.start, d.end) for d in trace.device]), lo, hi)


def device_ops(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The device operations inside the calls that took most time: ``[(name, seconds)]``."""
    by_name: Dict[str, float] = {}
    for events in trace.in_calls():
        for d in events:
            by_name[d.name] = by_name.get(d.name, 0.0) + (d.end - d.start) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def idle_gaps(trace: Trace, top: int = 10) -> List[Tuple[str, float]]:
    """The card's idle time in the traced window by what the host was doing: ``[(host operation, seconds)]``.

    A gap is named by the innermost host operation or span that holds its
    midpoint (``host: none`` where none does); gaps of one name are summed.
    """
    lo, hi = trace.window
    by_name: Dict[str, float] = {}
    host = sorted(trace.host, key=lambda h: (h.start, -h.end))
    active: List[Tuple[float, float, int]] = []  # (-start, -index, index): the latest started on top
    k = 0
    for s, e in gaps(union([(d.start, d.end) for d in trace.device]), lo, hi):  # in order of time
        mid = 0.5 * (s + e)
        while k < len(host) and host[k].start <= mid:
            heapq.heappush(active, (-host[k].start, -k, k))
            k += 1
        while active and host[active[0][2]].end < mid:  # ended before this gap, so before every later one
            heapq.heappop(active)
        name = host[active[0][2]].name if active else "host: none"
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:top]


def _kind(event) -> Optional[str]:
    """A device kind, ``"launch"`` (a runtime call that puts work on the card), ``"host"``, or None for what no reader takes.

    Where the profiler does not give an event's activity (older versions), the card's events are told by their
    device and the runtime's by their names.
    """
    activity = event.activity_type() if hasattr(event, "activity_type") else None
    name = event.name()
    if activity in KINDS:
        return KINDS[activity]
    if activity == "gpu_user_annotation" or name.startswith(SPAN_PREFIX):
        return None
    if activity is None and str(event.device_type()).endswith("CUDA"):
        return "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") else "kernel"
    if name.startswith("cu") and any(word in name for word in LAUNCH_WORDS):
        return "launch"
    return "host"


def from_profiler(prof, spans: Sequence[Tuple[str, int, int]]) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` session, read in memory (nothing is written).

    ``spans``: the harness's ``(name, start_ns, end_ns)`` on the Unix-time clock the profiler stamps its events
    in; those named :data:`CALL_SPAN` are the calls. Times become microseconds from the first span's start.
    """
    base = min(start for _, start, _ in spans)
    calls = sorted(((start - base) * 1e-3, (end - base) * 1e-3) for name, start, end in spans if name == CALL_SPAN)
    host = [HostEvent(name, (start - base) * 1e-3, (end - base) * 1e-3) for name, start, end in spans]
    device, launch_times = [], []
    for event in prof.profiler.kineto_results.events():
        kind = _kind(event)
        if kind is None:
            continue
        start = (event.start_ns() - base) * 1e-3
        end = start + event.duration_ns() * 1e-3
        if kind in ("launch", "host"):
            host.append(HostEvent(event.name(), start, end))
            if kind == "launch":
                launch_times.append(start)
        else:
            device.append(DeviceEvent(kind, event.name(), start, end))
    launches = sum(1 for t in launch_times if any(s <= t <= e for s, e in calls))
    return Trace(calls=calls, device=device, host=host, launches=launches)
