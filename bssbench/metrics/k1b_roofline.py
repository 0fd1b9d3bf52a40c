"""``k1b_roofline``: the IP1 sweep's least time over its kernels' measured time in the traced calls, in percent.

The operation (K1b, ``ssspy_tpu_torch/ops/csrc/ip1_sweep.cu``): one sequential
IP1 sweep of a bin's demixing matrix ``W (N, M)`` over its ``N`` Hermitian
covariances ``U_n (M, M)``; every bin of every utterance once an iteration.
Counted for what these inputs need, per bin:

- operations, for each source: the product ``W U_n`` (``8 M^3``), the LU
  solve of ``(W U_n) w = e_n`` (``8 M^3 / 3`` for the factors, ``8 M^2`` for
  the two triangular solves), ``U_n w`` (``8 M^2``) and ``w^H U_n w`` (``8 M``);
- bytes: ``W`` read and written once (``2 x 8 N M``), the upper half of each
  ``U_n`` read once (``8 N M (M + 1) / 2``).

The measured time is the summed duration of the kernels whose name holds
``ip1_sweep_kernel``.
"""

from bssbench.peaks import least_seconds

KERNEL = "ip1_sweep_kernel"


def flops(bins: int, N: int, M: int) -> float:
    return bins * N * (8 * M**3 + 8 * M**3 / 3 + 16 * M**2 + 8 * M)


def nbytes(bins: int, N: int, M: int) -> int:
    return bins * (16 * N * M + 8 * N * M * (M + 1) // 2)


def read(trace, ctx):
    s = ctx["shapes"]
    measured = sum(d.end - d.start for events in trace.in_calls(("kernel",)) for d in events if KERNEL in d.name)
    bins = s["B"] * s["I"]
    least = least_seconds(ctx["device_name"], flops(bins, s["N"], s["M"]), nbytes(bins, s["N"], s["M"]))
    if not measured or least is None:
        return None
    return 100.0 * least * s["n_iter"] * len(trace.calls) / (measured * 1e-6)
