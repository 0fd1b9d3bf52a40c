"""Profiling / observability helpers.

Counterpart of :mod:`ssspy_tpu.utils.profiling`. The port runs eagerly,
one PyTorch operation or hand-written kernel at a time, so observability
means ``torch.profiler`` traces, wall-clock timings that wait for the card,
and what can be counted of one call; there is no compiled program to ask.

- :func:`trace`, :func:`timed` and :func:`compiled_stats`, as the JAX
  package names them;
- the readers of device time that ``chip_smoke.py`` takes (and
  ``scripts/torch_kernel_ab.py`` copies): :func:`chain` (chained steps),
  :func:`profile` (a step's device time by kernel name) and
  :func:`profiled_us` (one kernel's own duration a call). Each profiler
  session opens with a spin kernel and is pooled with others until one saw
  every event, since a CUPTI session may drop some.
"""

import contextlib
import statistics
import time
from typing import Callable, Optional

import torch

__all__ = ["trace", "timed", "compiled_stats", "chain", "profile", "profiled_us", "N_ITER", "N_TIMED"]

N_ITER = 100  # chained steps of chain by default: a separator's default iterations
N_TIMED = 30  # timed runs per measurement, after warm-up


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed calls with ``torch.profiler`` (CPU activity, and CUDA where a card is present).

    The trace goes into ``log_dir`` as a Chrome / TensorBoard file
    (``tensorboard_trace_handler``: ``<worker>.<time>.pt.trace.json``),
    written when the block ends; the profiler is yielded.

    >>> with trace("bss-trace"):
    ...     iva(spectrogram, n_iter=100)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir)
    with torch.profiler.profile(activities=activities, on_trace_ready=handler) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in ``tree`` (nested tuples, lists and dicts)."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.is_cuda else set()
    if isinstance(tree, dict):
        return _cuda_devices(list(tree.values()))
    if isinstance(tree, (tuple, list)):
        return set().union(*map(_cuda_devices, tree))
    return set()


def _block(result) -> None:
    for device in _cuda_devices(result):
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, warmup: int = 1, repeat: int = 5, **kwargs):
    """Wall-clock seconds per call of ``fn(*args, **kwargs)``, the first ``warmup`` calls (kernel builds) excluded.

    Returns ``(seconds_per_call, last_result)``; waits for the card
    (``torch.cuda.synchronize``) where the result lives there.
    """
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
    _block(result)

    t0 = time.perf_counter()
    for _ in range(repeat):
        result = fn(*args, **kwargs)
    _block(result)
    return (time.perf_counter() - t0) / repeat, result


def _launches() -> int:
    from ..ops import kernels

    return sum(getattr(getattr(kernels, name), "launches", 0) for name in kernels.__all__)


def compiled_stats(fn: Callable, *args, **kwargs) -> Optional[dict]:
    """What one call of ``fn(*args, **kwargs)`` can be measured to cost: ``{"flops", "bytes_accessed", "peak_bytes"}``.

    The JAX function reads these from the compiled program; eager PyTorch
    compiles none, so one call is run and measured:

    - ``peak_bytes``: the card's memory the call held at its peak beyond
      what was allocated before it (its temporaries and outputs, as the JAX
      figure counts them), ``torch.cuda.max_memory_allocated`` after
      ``reset_peak_memory_stats``; ``None`` where neither the arguments nor
      the result hold a CUDA tensor;
    - ``flops``: the floating-point operations of the matrix products and
      convolutions that ``torch.utils.flop_counter.FlopCounterMode`` counts
      (elementwise work is not counted, and a complex product counts as a
      real one of its shape), only where the call launched no hand-written
      kernel (the launch counts of :mod:`ssspy_tpu_torch.ops.kernels`),
      whose work the counter cannot see; else ``None``;
    - ``bytes_accessed``: ``None``; nothing counts it.
    """
    from torch.utils.flop_counter import FlopCounterMode

    on_card = torch.cuda.is_available()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    launches = _launches()
    with FlopCounterMode(display=False) as counter:
        result = fn(*args, **kwargs)
    peak_bytes = None
    if on_card and _cuda_devices((args, kwargs, result)):
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated() - before
    flops = counter.get_total_flops() if _launches() == launches else None
    return {"flops": flops, "bytes_accessed": None, "peak_bytes": peak_bytes}


def chain(step, state, n_iter=N_ITER):
    for _ in range(n_iter):
        state = step(state)
    return state


def profile(step, state, n_iter: int = 20, attempts: int = 3):
    """Device microseconds per step by kernel name, device operations per step, the events seen and made, the
    sessions taken, and the names whose events do not divide by the steps (``torch.profiler`` over ``n_iter``
    chained steps): ``(per_kernel, ops, seen, made, sessions, uneven)``.

    Read as :func:`profiled_us` reads one kernel, since a session's CUPTI trace may drop events (its first most
    often, or all of them): each session opens with a spin kernel (``torch.cuda._sleep``, left out of the
    sums); a name's launches a step are its events over the steps, rounded up, and its time a step is its mean
    over the events seen times those launches; a session that saw fewer events than that makes is pooled with
    another, up to ``attempts``. ``per_kernel`` is empty when no session saw an event. A name launched a
    varying number of times a step cannot be told from one that lost events, so each name whose events are
    not a whole number a step is also given in ``uneven`` as ``(events, steps, us)``, ``us`` its time a step as
    seen, without the rounding up.
    """
    chain(step, state, 2)
    torch.cuda.synchronize()
    durations = {}
    for attempt in range(1, attempts + 1):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            chain(step, state, n_iter)
            torch.cuda.synchronize()
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in event.name:
                durations.setdefault(event.name, []).append(event.time_range.elapsed_us())
        per_step = {name: -(-len(us) // (attempt * n_iter)) for name, us in durations.items()}
        seen, made = sum(map(len, durations.values())), attempt * n_iter * sum(per_step.values())
        if seen == made and seen:
            break
    steps = attempt * n_iter
    per_kernel = {name: k * statistics.fmean(durations[name]) for name, k in per_step.items()}
    uneven = {name: (len(us), steps, sum(us) / steps) for name, us in durations.items() if len(us) % steps}
    return per_kernel, sum(per_step.values()), seen, made, attempt, uneven


def profiled_us(fn, kernel: str, n_runs: int = N_TIMED, attempts: int = 3):
    """Device microseconds per call of ``fn`` spent in the kernels of ``kernel`` (``<kernel>_kernel*``, as named in
    csrc/*.cu), by ``torch.profiler`` over sessions of ``n_runs`` calls, with the events seen and the launches
    made: ``(us, seen, made)``.

    Beside the CUDA-event time of :func:`median_ms`, which also holds the ~5 us that any launch reads between
    two events, this is the kernel's own duration. A session's CUPTI trace may drop events, its first most
    often, so a sum divided by the calls made would read low: each session opens with a spin kernel of
    another name, and one that saw fewer launches than were made is followed by another, up to ``attempts``.
    A call's launches of each kernel name are its events over the calls, rounded up, and the time is each
    name's mean over the events seen, times its launches a call. ``us`` is None when no event was seen.
    """

    def session():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            for _ in range(n_runs):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for event in prof.events():
            if event.device_type == torch.autograd.DeviceType.CUDA and f"{kernel}_kernel" in event.name:
                by_name.setdefault(event.name, []).append(event.time_range.elapsed_us())
        return by_name

    fn()
    torch.cuda.synchronize()
    durations = {}
    for attempt in range(1, attempts + 1):
        for name, us in session().items():
            durations.setdefault(name, []).extend(us)
        per_call = {name: -(-len(us) // (attempt * n_runs)) for name, us in durations.items()}
        seen, made = sum(map(len, durations.values())), attempt * n_runs * sum(per_call.values())
        if seen == made and seen:
            break
    if not durations:
        return None, 0, 0
    return sum(k * statistics.fmean(durations[name]) for name, k in per_call.items()), seen, made
