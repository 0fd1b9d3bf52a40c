#!/usr/bin/env python3
"""Where FasterIVA's shift-invert route (``eig_impl="solve"``) leaves its eigh route, step by step.

On the 8-channel 10 s mixture of ``chip_smoke.py`` (257 x 626, complex64,
whitened), it chains 100 FasterIVA steps from ``W = I`` whose top
eigenvectors come by shift-invert (``top_eigvec(impl="solve")``) and whose
polar factor is the eigh one, on ``--device``, with the eigh route's own
chain beside it. For each step it prints the contrast, the largest
singular value of the filters, the least singular value of the stacked top
eigenvectors before the polar factor, the worst Rayleigh quotient of the
shift-invert eigenvectors against the top eigenvalue (``eigvalsh`` in
complex128), the certified shift's distance above it and its factor's
least pivot, the largest entry of the triangular inverse, the largest
inverse-iteration iterate before normalization, how far the same input's
top eigenvectors on the host's CPU and by the eigh route lie from the
device's (``1 - |<v, v'>|``), how far the eigh polar of the two sets of
eigenvectors lies apart, and the contrast and conditioning of the eigh
route's chain. At the first step whose Rayleigh quotient misses by more
than 1e-3 it prints the worst (bin, source) cells. Then it runs each
``--variants`` chain 100 steps (``top_eigvec``'s ``impl`` and, after a
``+``, the polar factor's; ``eigh`` when left out: ``solve+qdwh`` is what
``faster_iva_step(eig_impl="solve")`` runs) and prints its contrast and the
filters' singular values.

    python3 scripts/torch_faster_iva_solve_drift.py --device cuda
"""

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssspy_tpu_torch.linalg import eig_free
from ssspy_tpu_torch.ops import fixed_point_iva_steps as fp
from ssspy_tpu_torch.ops.iva_steps import covariance, separate
from ssspy_tpu_torch.transform import stft
from ssspy_tpu_torch.utils.dataset import HOP, N_FFT, make_mixture


def shift_invert_stats(A, bisect_trips=12, inv_iters=3, tiny=1e-30):
    """:func:`eig_free.top_eigvec_shift_invert` step by step, with its certified shift, least pivot and magnitudes."""
    M = A.shape[-1]
    E = eig_free._symmetric_embed(A)
    eye2 = torch.eye(2 * M, dtype=E.dtype, device=E.device)
    gersh = torch.amax(torch.sum(E.abs(), dim=-1), dim=-1)
    x = eig_free.psd_power_probe(E)
    for _ in range(2):
        x = eig_free._unit(x, tiny)
        x = eig_free._mv(E, eig_free._mv(E, x))
    den = torch.sum(x * x, dim=-1)
    rayleigh = torch.where(den > 0, torch.sum(eig_free._mv(E, x) * x, dim=-1) / torch.clamp(den, min=tiny), 0.0)
    lo = rayleigh
    hi = gersh * (1 + 8 * torch.finfo(E.dtype).eps) + tiny
    for _ in range(bisect_trips):
        mid = (lo + hi) / 2
        pd = eig_free.chol_piv(mid[..., None, None] * eye2 - E, tiny=tiny)[1] > 0
        hi = torch.where(pd, mid, hi)
        lo = torch.where(pd, lo, mid)
    L, least = eig_free.chol_piv(hi[..., None, None] * eye2 - E, tiny=tiny)
    L_inv = eig_free.tri_lower_inv(L)
    v = x
    raw = torch.zeros_like(hi)
    for _ in range(inv_iters):
        v = eig_free._mtv(L_inv, eig_free._mv(L_inv, eig_free._unit(v, tiny)))
        raw = torch.maximum(raw, v.abs().amax(dim=-1))
    v = eig_free._unit(v, tiny)
    return torch.complex(v[..., :M], v[..., M:]), {"hi": hi, "least": least, "L": L, "L_inv": L_inv, "raw": raw}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--duration", type=float, default=10.0)
    parser.add_argument("--variants", nargs="*", default=["solve", "eigh", "solve+qdwh", "eigh+qdwh"])
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print("card:", smi.stdout.strip(), flush=True)
    wave = torch.from_numpy(make_mixture(seed=0, duration_s=args.duration)).to(device=device, dtype=torch.float32)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP, device=device)
    Z = fp.whiten_spectrogram(X)
    M, I, _ = Z.shape

    def loss(W):
        return float((2 * torch.linalg.vector_norm(separate(Z, W), dim=1)).mean(dim=-1).sum())

    W = torch.eye(M, dtype=Z.dtype, device=device).expand(I, -1, -1).contiguous()
    W_e = W.clone()
    reported = False
    for k in range(1, args.steps + 1):
        Y = separate(Z, W)
        U = covariance(Z, 2 / torch.clamp(2 * torch.linalg.vector_norm(Y, dim=1), min=1e-10))
        v, stats = shift_invert_stats(U)
        v_lib = eig_free.top_eigvec_shift_invert(U)
        same = bool(torch.equal(v, v_lib))
        lamb = torch.linalg.eigvalsh(U.to(torch.complex128))  # (I, N, M) ascending
        top = lamb[..., -1]
        quotient = torch.sum(v.conj().to(torch.complex128) * (U.to(torch.complex128) @ v.to(torch.complex128)[..., None])[..., 0], dim=-1).real
        miss = (quotient - top).abs() / top.abs().clamp(min=1e-300)
        v_cpu = eig_free.top_eigvec_shift_invert(U.cpu())
        overlap = torch.abs(torch.sum(v_cpu.conj() * v.cpu(), dim=-1))
        L_inv_cpu = eig_free.tri_lower_inv(stats["L"].cpu())
        linv_diff = float(((L_inv_cpu - stats["L_inv"].cpu()).abs() / L_inv_cpu.abs().amax(dim=(-2, -1), keepdim=True).clamp(min=1e-30)).amax())
        V = fp.top_eigvec(U, impl="solve").conj()
        W_next = fp.polar(V)
        V_k7 = fp.top_eigvec(U, impl="eigh").conj()
        k7_gap = torch.abs(torch.sum(V_k7.conj() * V, dim=-1))
        U_e = covariance(Z, 2 / torch.clamp(2 * torch.linalg.vector_norm(separate(Z, W_e), dim=1), min=1e-10))
        V_e = fp.top_eigvec(U_e, impl="eigh").conj()
        W_e = fp.polar(V_e)
        row = {
            "step": k, "loss": loss(W_next),
            "W_sv_max": float(torch.linalg.svdvals(W_next).amax()) if bool(torch.isfinite(W_next).all()) else float("nan"),
            "V_sv_min": float(torch.linalg.svdvals(V).amin()) if bool(torch.isfinite(V).all()) else float("nan"),
            "rayleigh_miss_max": float(miss.max()), "n_miss_gt_1e-3": int((miss > 1e-3).sum()),
            "shift_above_top_rel_min": float(((stats["hi"].double() - top) / top).min()),
            "least_pivot_min": float(stats["least"].min()),
            "L_inv_abs_max": float(stats["L_inv"].abs().amax()),
            "iterate_abs_max": float(stats["raw"].amax()),
            "nonfinite_v": int((~torch.isfinite(v)).sum()),
            "cpu_overlap_gap_max": float((1 - overlap).max()),
            "L_inv_card_vs_cpu_rel_max": linv_diff,
            "stats_equal_library": same,
            "U_scale": float(top.abs().amax()),
            "k7_same_input_overlap_gap_max": float((1 - k7_gap).max()),
            "k7_same_input_polar_rel": float(torch.linalg.vector_norm(fp.polar(V_k7) - W_next) / torch.linalg.vector_norm(W_next)),
            "eigh_chain_loss": loss(W_e),
            "eigh_chain_W_sv_max": float(torch.linalg.svdvals(W_e).amax()),
            "eigh_chain_V_sv_min": float(torch.linalg.svdvals(V_e).amin()),
        }
        print(json.dumps(row), flush=True)
        if not reported and float(miss.max()) > 1e-3:
            reported = True
            worst = torch.topk(miss.flatten(), 5).indices
            for flat in worst.tolist():
                i, n = divmod(flat, M)
                print(json.dumps({
                    "cell": [i, n], "miss": float(miss[i, n]), "eigs_top3": lamb[i, n, -3:].tolist(),
                    "shift": float(stats["hi"][i, n]), "least_pivot": float(stats["least"][i, n]),
                    "L_diag": stats["L"][i, n].diagonal().tolist(),
                    "iterate_abs_max": float(stats["raw"][i, n]),
                    "cpu_overlap_gap": float(1 - overlap[i, n]),
                    "cpu_miss": float((torch.sum(v_cpu[i, n].conj().double() * (U[i, n].cpu().double() @ v_cpu[i, n].double())).real - top[i, n].cpu()).abs() / top[i, n].abs().cpu()),
                }), flush=True)
        W = W_next

    for variant in args.variants:
        eig_impl, _, polar_impl = variant.partition("+")
        W = torch.eye(M, dtype=Z.dtype, device=device).expand(I, -1, -1).contiguous()
        for _ in range(args.steps):
            varphi = 2 / torch.clamp(2 * torch.linalg.vector_norm(separate(Z, W), dim=1), min=1e-10)
            W = fp.polar(fp.top_eigvec(covariance(Z, varphi), impl=eig_impl).conj(), impl=polar_impl or "eigh")
        finite = bool(torch.isfinite(W).all())
        print(json.dumps({"variant": variant, "steps": args.steps, "loss": loss(W), "finite": finite,
                          "W_sv_min_max": [float(torch.linalg.svdvals(W).amin()), float(torch.linalg.svdvals(W).amax())]
                          if finite else None}), flush=True)

if __name__ == "__main__":
    main()
