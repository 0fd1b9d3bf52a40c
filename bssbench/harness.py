"""One run of one cell: set-up, the measured window, the traced calls, and the comparison that decides ``correct``.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

- ``bssbench/configs/<config>.json`` (the file the configuration names): the
  algorithm, its arguments and the port entry for single and for batched
  traffic;
- ``bssbench/traffic/<traffic>.json``: recording length, recordings a call,
  the pool of distinct requests, the number of calls compared;
- ``bssbench/entries/<entry>.py``: ``make(config, device) -> call(request)``,
  one call of the port;
- ``bssbench/reference/<algorithm>.py``: ``separate(waveforms, config,
  draw_seed, device, precision)``, the plain reference;
- ``bssbench/metrics/<metric>.py``: ``read(trace, ctx)``, one per-layer metric;
- ``bssbench/limits/<workload>.json``: the limit of each number compared.

A call runs from handing the request's host-memory waveforms to the entry
until the separated waveforms are in host memory (``.cpu()`` of its output).
The loop is closed, with one caller cycling through the pool.
"""

import gc
import importlib.util
import json
import math
import statistics
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from bssbench import mixture, tracing
from bssbench.reference.common import stft

FORBIDDEN = ("jax", "jaxlib", "flax", "ssspy_tpu")
N_WARMUP = 2  # calls before the window: the first builds and plans, the second finds everything ready
N_TRACED = 3  # calls in the read profiler session
GAP_P90, BINS_OVER = "wave_bin_gap_p90", "wave_bins_over"
NUMBERS = (GAP_P90, BINS_OVER)  # the numbers compared, each with its limit in bssbench/limits/<workload>.json
BIN_QUANTILE = 0.9


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def load_module(path: Path, name: str):
    """The module in ``path``, registered as ``name`` so that its siblings can import it."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """One entry of ``workloads``, with its configuration, traffic, entry adapter, reference, metrics and limits."""

    def __init__(self, root, workload: str):
        self.root = Path(root)
        self.home = self.root / "bssbench"
        self.bench = load_json(self.root / "BENCHMARK.json")
        self.workload = _by_name(self.bench["workloads"], workload, "workload")
        self.name = workload
        self.config = load_json(self.root / _by_name(self.bench["configs"], self.workload["config"], "configuration")["file"])
        self.traffic = load_json(self.home / "traffic" / f"{self.workload['traffic']}.json")
        if self.traffic.get("loop", "closed") != "closed" or self.traffic.get("callers", 1) != 1:
            raise ValueError(f"traffic {self.workload['traffic']!r}: the harness drives a closed loop with one caller")
        kind = "batched" if self.traffic["recordings_per_call"] > 1 else "single"
        if kind not in self.config["entries"]:
            raise ValueError(f"configuration {self.config['name']!r} has no entry for {kind} traffic")
        self.entry_name = self.config["entries"][kind]
        self.entry = load_module(self.home / "entries" / f"{self.entry_name}.py", f"bssbench.entries.{self.entry_name}")
        algorithm = self.config["algorithm"]
        self.reference = load_module(self.home / "reference" / f"{algorithm}.py", f"bssbench.reference.{algorithm}")
        self.end_to_end = [m for m in self.bench["end_to_end"] if applies(m, workload)]
        self.per_layer = [m for m in self.bench["per_layer"] if applies(m, workload)]
        self.limits = load_json(self.home / "limits" / f"{workload}.json")
        missing = [name for name in NUMBERS if name not in self.limits]
        if missing:
            raise KeyError(f"bssbench/limits/{workload}.json gives no limit for {missing}")

    def reader(self, metric: str):
        return load_module(self.home / "metrics" / f"{metric}.py", f"bssbench.metrics.{metric}")

    def shapes(self) -> dict:
        """The sizes of one call: ``B`` recordings of ``S`` samples, ``M`` channels, ``N`` sources, ``I`` bins, ``T`` frames."""
        c, t = self.config, self.traffic
        n_samples = int(c["sample_rate"] * t["recording_seconds"])
        n_fft, hop = c["n_fft"], c["hop_length"]
        n_frames = max(math.ceil((n_samples + 2 * (n_fft // 2) - n_fft) / hop), 0) + 1
        return {"B": t["recordings_per_call"], "M": c["n_channels"], "N": c["n_sources"], "I": n_fft // 2 + 1,
                "T": n_frames, "S": n_samples, "K": c.get("n_basis", 0), "n_iter": c["n_iter"], "n_fft": n_fft,
                "hop": hop}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed_call(call, request, spans: Optional[list] = None):
    """One call: the entry, then the output's copy to host memory. With ``spans``, their host intervals go there.

    A span is ``(name, start_ns, end_ns)`` on ``time.time_ns``'s clock, the Unix-time clock the profiler's
    events are stamped in.
    """
    t0 = time.time_ns()
    out = call(request)
    t1 = time.time_ns()
    host = out.cpu()
    if spans is not None:
        t2 = time.time_ns()
        spans += [(tracing.CALL_SPAN, t0, t2), ("bssbench.entry", t0, t1), ("bssbench.to_host", t1, t2)]
    return host


@dataclass
class Window:
    latencies: List[float]
    audio_seconds: float
    seconds: float
    attempted: int
    failed: int
    error: Optional[str]
    kept: List[Tuple[int, int, torch.Tensor]] = field(default_factory=list)  # (call, request, output)


def run_window(call, pool, seconds: float, keep: int, rng: np.random.Generator) -> Window:
    """Calls back to back until ``seconds`` have passed, then the one under way ends the window.

    ``keep`` outputs are kept, a uniform sample of the calls drawn by
    ``rng`` (a reservoir), for the comparison once the window has closed. A
    call that raises is counted as failed and ends the window.
    """
    latencies, audio, kept, attempted, failed, error = [], 0.0, [], 0, 0, None
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        request = pool[attempted % len(pool)]
        t0 = time.perf_counter()
        attempted += 1
        try:
            out = timed_call(call, request)
        except Exception:  # the run goes on to report the failure; correct is then false
            failed += 1
            error = traceback.format_exc()
            break
        latencies.append(time.perf_counter() - t0)
        audio += request.audio_seconds
        if len(kept) < keep:
            kept.append((attempted - 1, request.index, out))
        else:
            slot = int(rng.integers(attempted))
            if slot < keep:
                kept[slot] = (attempted - 1, request.index, out)
    return Window(latencies, audio, time.perf_counter() - start, attempted, failed, error, kept)


def trace_calls(call, pool, device, n_calls: int = N_TRACED) -> tracing.Trace:
    """A ``torch.profiler`` session over ``n_calls`` whole calls, after one session of one call whose events are not read.

    On the card the session records the card's activity alone (kernels, copies, memsets and the runtime calls
    that launch them): recording every host operation as well would slow the host enough to change what is
    measured. The calls' host intervals come from the harness's own clock (:func:`timed_call`).
    """
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=activities):
        timed_call(call, pool[0])
        _sync(device)
    spans = []
    with profile(activities=activities) as prof:
        if on_card:
            torch.cuda._sleep(1000)  # the session's first device event, outside every call
        for k in range(n_calls):
            timed_call(call, pool[k % len(pool)], spans)
        _sync(device)
    return tracing.from_profiler(prof, spans)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst relative L2 gap over the separated waveforms (every source of every utterance), inf where not finite.

    Printed beside the number compared, not compared: a few ill-conditioned bins in which the float32 and the
    float64 iterations part move it by a few percent on a sound run (PERF.md, section 6).
    """
    if tuple(out.shape) != tuple(ref.shape):
        return math.inf
    ref = ref.to(torch.float64)
    gap = torch.linalg.vector_norm(out.to(torch.float64) - ref, dim=-1) / torch.linalg.vector_norm(ref, dim=-1)
    worst = float(gap.max())
    return worst if math.isfinite(worst) else math.inf


def bin_gaps(out: torch.Tensor, ref: torch.Tensor, config: dict) -> Optional[torch.Tensor]:
    """Per recording and frequency bin, the relative gap of the separated spectra: ``(U, I)``, or None.

    The program's and the reference's separated waveforms of each recording
    (``(N, S)``, or each of a batch's ``(B, N, S)``) are analysed with the
    reference's own STFT at the configuration's ``n_fft``/``hop_length``, in
    float64. A bin's gap is ``||P_i - R_i|| / ||R_i||`` over the recording's
    sources and frames. None where the shapes differ or a gap is not finite.
    """
    if tuple(out.shape) != tuple(ref.shape):
        return None
    n_fft, hop = config["n_fft"], config["hop_length"]
    out = out.reshape((-1,) + tuple(out.shape[-2:])).to(torch.float64)
    ref = ref.reshape((-1,) + tuple(ref.shape[-2:])).to(torch.float64)
    gaps = []
    for o, r in zip(out, ref):
        P, R = stft(o, n_fft, hop), stft(r, n_fft, hop)  # (N, I, T)
        gaps.append(torch.linalg.vector_norm(P - R, dim=(0, 2)) / torch.linalg.vector_norm(R, dim=(0, 2)))
    gaps = torch.stack(gaps)
    return gaps if bool(torch.isfinite(gaps).all()) else None


def numbers(out: torch.Tensor, ref: torch.Tensor, config: dict, limits: dict) -> dict:
    """The numbers compared, each the worst over the recordings of one output, None where there is no number.

    - ``wave_bin_gap_p90``: the 90th percentile of a recording's bin gaps
      (:func:`bin_gaps`). It covers the whole path (STFT, iterations, scale
      restoration, iSTFT: a fault in any of them moves every bin) and lets
      the few bins in which float32 and float64 trajectories part by
      rounding alone (up to 6 of 257 seen above 0.01) fall above the
      percentile.
    - ``wave_bins_over``: the count of a recording's bins whose gap is above
      the limits file's ``gap``. It catches a fault confined to fewer bins
      than the percentile leaves out: a block of bins, an edge bin, a tail
      block of a kernel.
    """
    gaps = bin_gaps(out, ref, config)
    if gaps is None:
        return {name: None for name in NUMBERS}
    return {GAP_P90: float(torch.quantile(gaps, BIN_QUANTILE, dim=-1).max()),
            BINS_OVER: int((gaps > limits[BINS_OVER]["gap"]).sum(dim=-1).max())}


def worst(a: dict, b: dict) -> dict:
    """Per number, the larger of two readings; None (no number) wins."""
    return {name: None if a[name] is None or b[name] is None else max(a[name], b[name]) for name in NUMBERS}


def compare(cell: Cell, pool, kept, device, precision: str = "float64") -> Tuple[dict, float]:
    """The kept outputs against the reference on their requests, the reference run once a request.

    Returns ``(numbers, rel_err)``: the numbers compared (:func:`numbers`)
    and the printed worst source gap (:func:`rel_err`), each the worst over
    the kept outputs.
    """
    refs, found, worst_source = {}, {name: 0 for name in NUMBERS}, 0.0
    for _, index, out in kept:
        if index not in refs:
            request = pool[index]
            refs[index] = cell.reference.separate(request.waveforms, cell.config, request.draw_seed, device, precision)
        found = worst(found, numbers(out, refs[index], cell.config, cell.limits))
        worst_source = max(worst_source, rel_err(out, refs[index]))
    return found, worst_source


def control_numbers(cell: Cell, pool, indices, device) -> dict:
    """The control's numbers: the reference in the control precision put in the program's place."""
    kept = [(k, index, cell.reference.separate(pool[index].waveforms, cell.config, pool[index].draw_seed, device,
                                               "tf32")) for k, index in enumerate(indices)]
    return compare(cell, pool, kept, device)[0]


def within(checks: dict) -> bool:
    """Every number compared is there and at most its limit."""
    return all(check["value"] is not None and check["value"] <= check["limit"] for check in checks.values())


def forbidden_modules(names=FORBIDDEN) -> List[str]:
    """The top-level names of ``sys.modules`` among ``names``, compared whole."""
    return sorted({module.split(".")[0] for module in list(sys.modules)} & set(names))


def seeded_rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", process_start: Optional[float] = None):
    """One run: returns ``(result, checks, notes)``.

    ``result`` is the line to print (the contract's keys; ``checks`` last),
    ``checks`` each number compared with its limit, ``notes`` lines for
    standard error. ``process_start`` is this process's start on
    ``time.perf_counter``'s clock (set-up runs from it to the window).
    """
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = cell.config["tf32"]
    torch.backends.cudnn.allow_tf32 = cell.config["tf32"]
    process_start = time.perf_counter() if process_start is None else process_start
    notes = []

    t_pool = time.perf_counter()
    pool = mixture.make_pool(seed, cell.config, cell.traffic)
    t_entry = time.perf_counter()
    call = cell.entry.make(cell.config, device)
    t_warm = time.perf_counter()
    for k in range(N_WARMUP):
        timed_call(call, pool[k % len(pool)])
    _sync(device)
    setup_s = time.perf_counter() - process_start
    notes.append(f"set-up: {setup_s:.3f} s from the process's start: before the pool {t_pool - process_start:.3f} s, "
                 f"pool {t_entry - t_pool:.3f} s, entry {t_warm - t_entry:.3f} s, "
                 f"{N_WARMUP} warm-up calls {time.perf_counter() - t_warm:.3f} s")

    traced = trace_calls(call, pool, device) if trace else None
    window = run_window(call, pool, seconds, int(cell.traffic["compare_calls"]), seeded_rng(seed, 1))
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if window.error:
        notes.append(f"call {window.attempted - 1} failed:\n{window.error}")
    del call
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    found, worst_source = compare(cell, pool, window.kept, device)
    notes.append(f"reference: {len({k for _, k, _ in window.kept})} request(s) in {time.perf_counter() - t0:.3f} s; "
                 f"worst source's relative L2 gap {worst_source!r} (printed, not compared)")
    checks = {name: {"value": found[name], "limit": cell.limits[name]["limit"]} for name in NUMBERS}
    checks["calls_failed"] = {"value": window.failed, "limit": 0}
    correct = bool(window.attempted and window.kept and within(checks))

    metrics, device_info = {}, {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name() if on_card else "cpu",
        "count": cell.workload["chips"] if on_card else 1,
        "memory_peak_bytes": memory_peak,
    }
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed}
    if trace:
        ctx = {"config": cell.config, "traffic": cell.traffic, "shapes": cell.shapes(),
               "device_name": device_info["kind"], "reference": cell.reference}
        for metric in cell.per_layer:
            value = cell.reader(metric["name"]).read(traced, ctx) if traced.calls else None
            if value is not None:
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
        lo, hi = traced.window if traced.calls else (0.0, 0.0)
        device_info["busy_s"] = tracing.busy_us(traced) * 1e-6 if traced.calls else 0.0
        device_info["window_s"] = (hi - lo) * 1e-6
        result["breakdown"] = {"device_ops": [list(kv) for kv in tracing.device_ops(traced)],
                               "idle_gaps": [list(kv) for kv in tracing.idle_gaps(traced)] if traced.calls else []}
        notes.append(f"trace: {len(traced.calls)} calls; {traced.seen()} device events inside them of "
                     f"{len(traced.device)} in the session, {traced.launches} launched by the runtime inside them")
    else:
        values = {
            "setup_s": setup_s,
            "audio_rate": window.audio_seconds / window.seconds,
            "latency_p95": 1e3 * _p95(window.latencies) if window.latencies else None,
        }
        for metric in cell.end_to_end:
            if values.get(metric["name"]) is not None:
                metrics[metric["name"]] = {"value": values[metric["name"]], "unit": metric["unit"]}
        if window.latencies:
            q = statistics.quantiles(window.latencies, n=100, method="inclusive") if len(window.latencies) > 1 else []
            notes.append(f"window: {window.attempted} calls in {window.seconds:.3f} s; latency ms min "
                         f"{1e3 * min(window.latencies):.3f}, median {1e3 * statistics.median(window.latencies):.3f}, "
                         + ", ".join(f"p{k} {1e3 * q[k - 1]:.3f}" for k in (90, 95, 99) if q)
                         + f", max {1e3 * max(window.latencies):.3f}")
    result.update(metrics=metrics, device=device_info)
    result["checks"] = checks
    return result, checks, notes


def _p95(values: List[float]) -> float:
    """The 95th percentile of all values (linear between order statistics)."""
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]
