"""Run one cell of the benchmark of ssspy_tpu_torch once, on the card of this machine, and print its result line.

    python3 bssbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line on standard output is the
result (JSON); the last lines on standard error are each number compared,
beside its limit. Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits with 2; when a module of JAX or of the
JAX package was loaded, with 3. Every build and kernel cache goes under
``.bssbench_cache/`` in the checkout, at fixed paths.
"""

import argparse
import ctypes
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bssbench_cache")
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3  # glibc malloc.h


def process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (``/proc/self/stat``), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            started = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return now
    return now - age if 0.0 <= age < 120.0 else now


def tune_process(settings: dict) -> None:
    """Apply the configuration's ``process`` settings: the process a deployment of it runs the program in.

    ``malloc_mmap_threshold`` and ``malloc_trim_threshold`` (bytes) fix
    glibc's thresholds, which otherwise move with the history of frees: by
    default glibc raises its mmap threshold to the size of the last mapped
    block freed (up to 32 MiB), so whether a call's ~31 MB output lands in
    fresh pages (and faults them in during the copy) or in reused heap
    depends on what the process happened to free before. ``torch_threads``
    sets torch's host threads. A setting left out keeps the default a user's
    process has. PERF.md, section 2, gives readings with and without them.
    """
    mallopt = {"malloc_mmap_threshold": M_MMAP_THRESHOLD, "malloc_trim_threshold": M_TRIM_THRESHOLD}
    if mallopt.keys() & settings.keys():
        libc = ctypes.CDLL(None)
        libc.mallopt.argtypes, libc.mallopt.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
        for key, param in mallopt.items():
            if key in settings and libc.mallopt(param, int(settings[key])) != 1:
                raise OSError(f"mallopt refused {key} = {settings[key]}")
    if "torch_threads" in settings:
        import torch

        torch.set_num_threads(int(settings["torch_threads"]))


def main(argv=None) -> int:
    start = process_start()
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    sys.path.insert(0, ROOT)

    import torch

    from bssbench import harness

    cell = harness.Cell(ROOT, args.workload)
    tune_process(cell.config.get("process", {}))
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bssbench: {args.workload} needs {chips} CUDA card(s); this machine has {found}. No result.",
              file=sys.stderr)
        return 2

    result, checks, notes = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", start)
    forbidden = harness.forbidden_modules()
    if forbidden:
        print(f"bssbench: modules of {forbidden} were loaded in this process. No result.", file=sys.stderr)
        return 3
    for note in notes:
        print(note, file=sys.stderr)
    print(json.dumps(result), flush=True)
    for name, check in checks.items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
