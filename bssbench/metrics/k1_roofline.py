"""``k1_roofline``: the weighted covariance's least time over its kernels' measured time in the traced calls, in percent.

The operation (K1, ``ssspy_tpu_torch/ops/csrc/weighted_covariance.cu``):
``U[i, n] = mean_t phi[n, (i,) t] x_it x_it^H`` of one utterance's ``X (M, I, T)``
for its ``N`` sources, once per utterance an iteration. Counted for what
these inputs need, whatever an implementation does again. The output is
Hermitian, so its upper half, ``P = M (M + 1) / 2`` entries a matrix:

- operations, per bin and frame: the outer product's half once, ``6 P - 3 M``
  (a complex product off the diagonal, a squared magnitude on it), then for
  each source the weight times it and the running sum, ``4 P - 2 M``;
- bytes: ``X`` read once (``8 M I T``), the weights once (``4 N T``, or
  ``4 N I T`` where they are per bin), the output's half written once
  (``8 I N P``).

The measured time is the summed duration of the kernels whose name holds
``weighted_covariance_kernel``. A later implementation under another name
leaves this metric unread until a benchmark change points it there.
"""

from bssbench.peaks import least_seconds

KERNEL = "weighted_covariance_kernel"


def flops(M: int, N: int, I: int, T: int) -> int:
    P = M * (M + 1) // 2
    return I * T * ((6 * P - 3 * M) + N * (4 * P - 2 * M))


def nbytes(M: int, N: int, I: int, T: int, per_bin: bool) -> int:
    P = M * (M + 1) // 2
    return 8 * M * I * T + 4 * N * T * (I if per_bin else 1) + 8 * I * N * P


def read(trace, ctx):
    s = ctx["shapes"]
    measured = sum(d.end - d.start for events in trace.in_calls(("kernel",)) for d in events if KERNEL in d.name)
    least = least_seconds(ctx["device_name"], flops(s["M"], s["N"], s["I"], s["T"]),
                          nbytes(s["M"], s["N"], s["I"], s["T"], ctx["config"]["weights_per_bin"]))
    if not measured or least is None:
        return None
    return 100.0 * least * s["B"] * s["n_iter"] * len(trace.calls) / (measured * 1e-6)
