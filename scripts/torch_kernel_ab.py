#!/usr/bin/env python3
"""Time the covariance (K1) and batched-inverse (K3) kernels of one tree of ssspy_tpu_torch on the card.

Imports ``ssspy_tpu_torch`` from ``--root`` (the repository root by
default, or an unpacked copy of another commit), builds its two kernels
there and times them on the inputs ``chip_smoke.py`` times them on: the
8-channel, 10 s, 16 kHz mixture (STFT 512/256: 257 bins x 626 frames) with
the fast-path Laplace weights ``(N, T)`` and random per-bin weights
``(N, I, T)``, and IPSDTA's projected model after two iterations of
``fast_gauss_ipsdta`` (315,504 systems of 4 x 4 and 5,008 of 5 x 5); and,
for the two other kernels on the shared elimination (``gj_inverse.cuh``),
the inverse sandwich K4 and the fused model pass K5 on dense GaussMNMF's
model after two iterations (160,882 systems of 8 x 8). Each
time is the median of 30 runs between CUDA events, the card kept busy
first (chip_smoke's ``device_ms``); beside them, a one-element fill under
the same timing, the least any launch reads. To compare two commits on one
card, run both in one call, in turns:

    python3 scripts/torch_kernel_ab.py --root _tree/parent --label parent
    python3 scripts/torch_kernel_ab.py --label change

Prints one JSON line per run, beside the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

N_TIMED = 30
SPIN_CYCLES = 20_000_000
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def median_ms(fn, n_runs=N_TIMED, n_warmup=3):
    """chip_smoke.median_ms(queued=True): the device's own time from the first launch to the last."""
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from ssspy_tpu_torch.fast import fast_gauss_ipsdta, fast_gauss_mnmf_dense
    from ssspy_tpu_torch.ops import _build, ipsdta_steps
    from ssspy_tpu_torch.ops import kernels as K
    from ssspy_tpu_torch.ops.iva_steps import separate
    from ssspy_tpu_torch.ops.mnmf_steps import instant_covariance, psd_project
    from ssspy_tpu_torch.transform import stft
    from ssspy_tpu_torch.utils.dataset import HOP, N_FFT, make_mixture

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("weighted_covariance", "gj_inverse", "inv_sandwich", "mnmf_model_traces")
    for name in names:
        _build.load(name)
    ptxas = {name: [line.split("ptxas info    : ")[-1].strip() for line in _build.build_info[name]["log"].splitlines()
                    if "Used" in line or "spill" in line] for name in names}

    # chip_smoke's inputs
    wave = torch.from_numpy(make_mixture(seed=0)).to(device=device, dtype=torch.float32)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP)
    M, I, T = X.shape
    W_eye = torch.eye(M, dtype=X.dtype, device=device).expand(I, -1, -1).contiguous()
    phi_scalar = (1.0 / torch.clamp(torch.linalg.vector_norm(separate(X, W_eye), dim=1), min=1e-10)).contiguous()
    phi_bins = torch.from_numpy(np.random.default_rng(0).random((M, I, T), dtype=np.float32) + 0.1).to(device)
    _, (T_ip, V_ip), _ = fast_gauss_ipsdta(X, n_basis=8, n_blocks=64, n_iter=2, rng=np.random.default_rng(0))
    R_ip = [psd_project(ipsdta_steps._model(Tp, V_ip), 1e-10, "ridge").contiguous() for Tp in T_ip]
    X_conj = X.conj().resolve_conj()
    # dense GaussMNMF's model after two fused iterations: the inputs of the
    # other two kernels on the shared elimination (gj_inverse.cuh)
    XX = instant_covariance(X, eps=1e-10)
    _, (T_mn, V_mn, H_mn) = fast_gauss_mnmf_dense(X, n_basis=8, n_iter=2, rng=np.random.default_rng(0))
    Lamb = (T_mn @ V_mn).contiguous()
    R_mn = psd_project(torch.einsum("nit,nipq->itpq", Lamb.to(X.dtype), H_mn), 1e-10, "ridge").contiguous()

    def wcov_bound(per_bin):
        n_bytes = M * I * T * 8 + (M * I * T if per_bin else M * T) * 4 + I * M * M * M * 8
        return bound_ms(n_bytes, I * T * (M * (M + 1) // 2) * (6 + 4 * M))

    def gj_bound(R):
        m = R.shape[-1]
        B = R.numel() // (m * m)
        return bound_ms(2 * B * m * m * 8, 16 * B * m**3)

    rows = {
        "weighted_covariance (N,T)": (lambda: K.weighted_covariance(X, phi_scalar),
                                      lambda: torch.einsum("nt,pit,qit->inpq", phi_scalar.to(X.dtype), X, X_conj),
                                      wcov_bound(False)),
        "weighted_covariance (N,I,T)": (lambda: K.weighted_covariance(X, phi_bins),
                                        lambda: torch.einsum("nit,pit,qit->inpq", phi_bins.to(X.dtype), X, X_conj),
                                        wcov_bound(True)),
        "gj_inverse (8,626,63,4,4)": (lambda: K.gj_inverse(R_ip[0]), lambda: torch.linalg.inv_ex(R_ip[0]),
                                      gj_bound(R_ip[0])),
        "gj_inverse (8,626,1,5,5)": (lambda: K.gj_inverse(R_ip[1]), lambda: torch.linalg.inv_ex(R_ip[1]),
                                     gj_bound(R_ip[1])),
    }
    # unchanged kernels that share gj_inverse.cuh: their times alone
    rows["inv_sandwich (160882,8,8)"] = (lambda: K.inv_sandwich(R_mn, XX), None, None)
    rows["model_traces (8,257,626,8)"] = (lambda: K.model_traces(Lamb, H_mn, XX, 1e-10), None, None)
    out = {"label": args.label, "root": args.root, "card": card, "torch": torch.__version__, "ptxas": ptxas}
    # the least that one launch reads under this timing: a one-element fill
    one = torch.zeros(1, device=device)
    out["one_element_fill_ms"] = median_ms(one.zero_)
    for key, (kernel, library, bound) in rows.items():
        ms = median_ms(kernel)
        out[key] = {"ms": ms}
        if library is not None:
            out[key].update(library_ms=median_ms(library), bound_ms=bound, bound_share=bound / ms)
    print(json.dumps(out), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
