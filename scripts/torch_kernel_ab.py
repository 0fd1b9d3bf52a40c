#!/usr/bin/env python3
"""Time the CUDA kernels of one tree of ssspy_tpu_torch on the card, and the ISS1 sweep's variants against each other.

Imports ``ssspy_tpu_torch`` from ``--root`` (the repository root by
default, or an unpacked copy of another commit), builds its kernels there
and times them on the inputs ``chip_smoke.py`` times them on: the
8-channel, 10 s, 16 kHz mixture (STFT 512/256: 257 bins x 626 frames) with
the fast-path Laplace weights ``(N, T)`` and random per-bin weights
``(N, I, T)``; the IP1 sweep from the identity on the covariance of those
weights; and IPSDTA's projected model after two iterations of
``fast_gauss_ipsdta`` (315,504 systems of 4 x 4 and 5,008 of 5 x 5); and,
for the two other kernels on the shared elimination (``gj_inverse.cuh``),
the inverse sandwich K4 and the fused model pass K5 on dense GaussMNMF's
model after two iterations (160,882 systems of 8 x 8); the IPA
congruence round (K6) and the Jacobi eigh (K7) on seeded random inputs of
the shapes chip_smoke times them at, and K6 also at every other N = S up
to 16. Each time is the median of 30 runs
between CUDA events, the card kept busy first (chip_smoke's
``device_ms``), beside the kernel's own duration per launch by
``torch.profiler`` over 30 launches (``profiler_us``, beside the events
its session saw of those launched, ``profiler_events``) and, for the two
sweeps, the inverse sandwich and the congruence round, the time with the
L2 cache flushed before each run (``cold_ms``);
beside them, a one-element fill under the same timing, the least any
launch reads. The IP1 sweep also runs on chip_smoke's own sweep input (two
silent bins), held against its exact elimination twin. The ISS1 sweep runs each variant that can take a shape
on both sides of the variants' boundaries at N = 8 (1,280 and 2,000
frames), whatever its predicate would choose, through the launch's
``variant`` argument (0 streamed, 1 resident, 2 registers), so that each
boundary can be checked against the times. To compare two commits on one
card, run both in one call, in turns:

    python3 scripts/torch_kernel_ab.py --root _tree/parent --label parent
    python3 scripts/torch_kernel_ab.py --label change

``--only PREFIX`` times only the rows whose name starts with it (and
skips the sweep checks and the ISS1 variants). Prints one JSON line per
run, beside the card's name and power limit.

``profiled_us`` is a copy of ``ssspy_tpu_torch.utils.profiling.profiled_us``
(a CPU test holds the two equal): the script imports the package of the
tree it times, and a tree from before that module has none.
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


def median_ms(fn, n_runs=N_TIMED, n_warmup=3, flush=None):
    """chip_smoke.median_ms(queued=True): the device's own time from the first launch to the last.

    ``flush``: a tensor larger than the L2 cache, written before each run, so that ``fn`` finds its
    inputs in device memory, as a step that ran other kernels since may (a "cold" time).
    """
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.fill_(1.0)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S) * 1e3


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--only", default="", help="time only the rows whose name starts with this")
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
    names = ("weighted_covariance", "ip1_sweep", "iss1_sweep", "gj_inverse", "inv_sandwich", "mnmf_model_traces",
             "ipa_congruence", "jacobi_eigh")
    for name in names:
        _build.load(name)
    ptxas = {name: [line.split("ptxas info    : ")[-1].strip() for line in _build.build_info[name]["log"].splitlines()
                    if "Used" in line or "spill" in line] for name in names}

    # chip_smoke's inputs
    wave = torch.from_numpy(make_mixture(seed=0)).to(device=device, dtype=torch.float32)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP, device=device)
    M, I, T = X.shape
    W_eye = torch.eye(M, dtype=X.dtype, device=device).expand(I, -1, -1).contiguous()
    phi_scalar = (1.0 / torch.clamp(torch.linalg.vector_norm(separate(X, W_eye), dim=1), min=1e-10)).contiguous()
    phi_bins = torch.from_numpy(np.random.default_rng(0).random((M, I, T), dtype=np.float32) + 0.1).to(device)
    _, (T_ip, V_ip), _ = fast_gauss_ipsdta(X, n_basis=8, n_blocks=64, n_iter=2, rng=np.random.default_rng(0))
    R_ip = [psd_project(ipsdta_steps._model(Tp, V_ip), 1e-10, "ridge").contiguous() for Tp in T_ip]
    X_conj = X.conj().resolve_conj()
    U_main = K.weighted_covariance(X, phi_scalar)
    # dense GaussMNMF's model after two fused iterations: the inputs of the
    # other two kernels on the shared elimination (gj_inverse.cuh)
    XX = instant_covariance(X, eps=1e-10)
    _, (T_mn, V_mn, H_mn) = fast_gauss_mnmf_dense(X, n_basis=8, n_iter=2, rng=np.random.default_rng(0))
    Lamb = (T_mn @ V_mn).contiguous()
    R_mn = psd_project(torch.einsum("nit,nipq->itpq", Lamb.to(X.dtype), H_mn), 1e-10, "ridge").contiguous()

    def wcov_bound(per_bin):
        n_bytes = M * I * T * 8 + (M * I * T if per_bin else M * T) * 4 + I * M * M * M * 8
        return bound_ms(n_bytes, I * T * (M * (M + 1) // 2) * (6 + 4 * M))

    def ip1_bound():
        # chip_smoke.ip1_bound at N = M: read U and W, write W
        n_bytes = I * M**3 * 8 + 2 * I * M * M * 8
        return bound_ms(n_bytes, I * M * (8 * M**3 + 8 * M**3 / 3 + 24 * M * M + 8 * M))

    def iss1_bound(per_bin):
        # chip_smoke.iss1_bound: read Y and phi, write Y
        n_bytes = 2 * M * I * T * 8 + (M * I * T if per_bin else M * T) * 4
        return bound_ms(n_bytes, 20 * M * M * I * T)

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
        "ip1_sweep (257,8,8)": (lambda: K.ip1_sweep(W_eye, U_main), None, ip1_bound()),
        "iss1_sweep (N,T)": (lambda: K.iss1_sweep(X, phi_scalar, 1e-6), None, iss1_bound(False)),
        "iss1_sweep (N,I,T)": (lambda: K.iss1_sweep(X, phi_bins, 1e-6), None, iss1_bound(True)),
        "gj_inverse (8,626,63,4,4)": (lambda: K.gj_inverse(R_ip[0]), lambda: torch.linalg.inv_ex(R_ip[0]),
                                      gj_bound(R_ip[0])),
        "gj_inverse (8,626,1,5,5)": (lambda: K.gj_inverse(R_ip[1]), lambda: torch.linalg.inv_ex(R_ip[1]),
                                     gj_bound(R_ip[1])),
    }
    # the inverse sandwich (against inv_ex and two matmul, chip_smoke's library call) and the fused model
    # pass, on the dense-MNMF model
    B_mn = R_mn.numel() // (M * M)

    def library_inv_sandwich():
        R_inv = torch.linalg.inv_ex(R_mn)[0]
        return R_inv, (R_inv @ XX) @ R_inv

    rows["inv_sandwich (160882,8,8)"] = (lambda: K.inv_sandwich(R_mn, XX), library_inv_sandwich,
                                         bound_ms(4 * B_mn * M * M * 8, 32 * B_mn * M**3))
    rows["model_traces (8,257,626,8)"] = (lambda: K.model_traces(Lamb, H_mn, XX, 1e-10), None, None)
    # K6 and K7 on seeded random inputs of chip_smoke's shapes: a congruence near the identity, and symmetric
    # matrices (a fixed count of Jacobi rounds, so the time hardly depends on the values)
    ab_rng = np.random.default_rng(5)

    def random_complex(shape):
        return torch.complex(*(torch.from_numpy(ab_rng.standard_normal(shape, dtype=np.float32))
                               for _ in range(2))).to(device)

    T_c = torch.eye(M, dtype=X.dtype, device=device) + 0.1 * random_complex((I, M, M))
    U_c = random_complex((I, M, M, M))
    U_c = (U_c + U_c.mH).contiguous()
    G_c = random_complex((I, M, M))
    rows["ipa_congruence (257,8,8,8)"] = (
        lambda: K.ipa_congruence(T_c, U_c, G_c),
        lambda: (torch.matmul(torch.matmul(T_c[:, None], U_c), T_c.mH[:, None]), torch.matmul(T_c, G_c)),
        bound_ms(I * M * M * 8 * (2 * M + 3), I * 8 * M**3 * (2 * M + 1)),
    )
    for B, n in ((257, 16), (257, 14), (2056, 16), (4032, 8), (160882, 16)):
        A = torch.from_numpy(ab_rng.standard_normal((B, n, n), dtype=np.float32)).to(device)
        A = (A + A.transpose(-1, -2)).contiguous()
        rows[f"jacobi_eigh ({B},{n},{n})"] = (lambda A=A: K.jacobi_eigh(A), None, None)
    # K6 at every other channel count the kernel takes, N = S, on the same kind of input
    for n in (n for n in range(1, 17) if n != M):
        T_n = torch.eye(n, dtype=X.dtype, device=device) + 0.1 * random_complex((I, n, n))
        U_n = random_complex((I, n, n, n))
        U_n = (U_n + U_n.mH).contiguous()
        G_n = random_complex((I, n, n))
        rows[f"ipa_congruence ({I},{n},{n},{n})"] = (
            lambda T_n=T_n, U_n=U_n, G_n=G_n: K.ipa_congruence(T_n, U_n, G_n),
            lambda T_n=T_n, U_n=U_n, G_n=G_n: (torch.matmul(torch.matmul(T_n[:, None], U_n), T_n.mH[:, None]),
                                               torch.matmul(T_n, G_n)),
            bound_ms(I * n * n * 8 * (2 * n + 3), I * 8 * n**3 * (2 * n + 1)),
        )
    rows = {key: row for key, row in rows.items() if key.startswith(args.only)}
    out = {"label": args.label, "root": args.root, "card": card, "torch": torch.__version__, "ptxas": ptxas}
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=device)  # 256 MB, five times the L2 cache
    if not args.only:  # with --only, the named rows alone
        # K1b on chip_smoke's own sweep input (the same draws: W near the identity, bins 0 and 128 silent),
        # against its exact elimination twin (gjnp) on the live bins, with the twin's own float32 error
        rng = np.random.default_rng(0)
        rng.random((M, I, T), dtype=np.float32)  # chip_smoke's per-bin weights come first
        noise = rng.standard_normal((2, I, M, M)).astype(np.float32)
        W0 = W_eye + 0.1 * torch.complex(torch.from_numpy(noise[0]), torch.from_numpy(noise[1])).to(device)
        U_silent = U_main.clone()
        U_silent[[0, 128]] = 0
        live = [i for i in range(I) if i not in (0, 128)]
        twin = K.ip1_sweep_plain(W0, U_silent, solve_impl="gjnp")
        twin64 = K.ip1_sweep_plain(W0.to(torch.complex128), U_silent.to(torch.complex128), solve_impl="gjnp")
        got = K.ip1_sweep(W0, U_silent)
        out["ip1_sweep silent bins"] = {
            "ms": median_ms(lambda: K.ip1_sweep(W0, U_silent)),
            "rel_err_vs_gjnp_twin": float((got[live] - twin[live]).abs().max() / twin[live].abs().max()),
            "twin_rel_err_vs_complex128": float((twin[live].to(torch.complex128) - twin64[live]).abs().max()
                                                / twin64[live].abs().max()),
            "frozen": bool(torch.equal(got[0], W0[0]) and torch.equal(got[128], W0[128])),
        }
    # the least that one launch reads under this timing: a one-element fill
    one = torch.zeros(1, device=device)
    out["one_element_fill_ms"] = median_ms(one.zero_)
    for key, (kernel, library, bound) in rows.items():
        ms = median_ms(kernel)
        us, seen, made = profiled_us(kernel, key.split()[0])
        out[key] = {"ms": ms, "profiler_us": us, "profiler_events": f"{seen}/{made}"}
        if key.startswith(("ip1", "iss1", "inv_sandwich", "ipa_congruence")):
            out[key]["cold_ms"] = median_ms(kernel, flush=flush)
        if bound is not None:
            out[key].update(bound_ms=bound, bound_share=bound / ms)
        if library is not None:
            out[key]["library_ms"] = median_ms(library)
    if args.only:
        print(json.dumps(out), flush=True)
        print(card, flush=True)
        return
    # the ISS1 sweep's variants on both sides of their boundaries at N = 8, each launched as the launch's
    # `variant` names it (a variant that cannot take the shape returns an error, which raises)
    lib, launch = K._entry("iss1_sweep")

    def iss1_as(Y, phi, variant):
        Y_out = torch.empty_like(Y)
        N_, I_, T_ = Y.shape
        status = launch(Y.data_ptr(), phi.data_ptr(), Y_out.data_ptr(), N_, I_, T_, int(phi.dim() == 3), variant,
                        1e-6, Y.device.index, K._stream(Y.device))
        _build.check(lib, "iss1_sweep", status)
        return Y_out

    # the variants a tree's launch knows: an older tree's kernel takes only 0 and 1
    variants = {"streamed": 0, "resident": 1}
    if hasattr(K, "iss1_sweep_variant"):
        variants["registers"] = 2
    for T_v in (1280, 2000):
        Y_v = random_complex((M, I, T_v))
        for per_bin in (False, True):
            phi_v = torch.from_numpy(ab_rng.random((M, I, T_v) if per_bin else (M, T_v), dtype=np.float32) + 0.1)
            phi_v = phi_v.to(device)
            entry = {"chosen": K.iss1_sweep_variant(M, T_v, per_bin) if hasattr(K, "iss1_sweep_variant")
                     else ("resident" if K.iss1_sweep_resident(M, T_v, per_bin) else "streamed")}
            first = None
            for name, code in variants.items():
                if name == "registers" and K.iss1_sweep_variant(M, T_v, per_bin) != "registers":
                    continue  # past the register variant's frames: its launch refuses the shape
                if name == "resident" and not K.iss1_sweep_resident(M, T_v, per_bin):
                    continue
                fn = lambda phi_v=phi_v, code=code: iss1_as(Y_v, phi_v, code)
                got = fn()
                first = got if first is None else first
                us, seen, made = profiled_us(fn, "iss1_sweep")
                entry[name] = {"ms": median_ms(fn), "cold_ms": median_ms(fn, flush=flush),
                               "profiler_us": us, "profiler_events": f"{seen}/{made}",
                               "rel_err_vs_first": float((got - first).abs().max() / first.abs().max())}
            out[f"iss1_sweep variants ({M},{I},{T_v}) {'(N,I,T)' if per_bin else '(N,T)'}"] = entry
    print(json.dumps(out), flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
