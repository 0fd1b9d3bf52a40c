#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ssspy_tpu_torch) on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``ssspy_tpu_torch/ops/csrc``,
checks each against its plain PyTorch version at the main-path shapes,
then drives the port's main path — AuxIVA-IP1 on the 8-channel, 10 s,
16 kHz synthetic mixture (STFT 512/256: 257 bins x 626 frames), 100
iterations, through ``AuxLaplaceIVA(spatial_algorithm="IP")``,
``fast_auxiva(algorithm="IP1")`` and the waveform-to-waveform
``separate`` — and holds its outputs against the same iterations run
through the plain versions. Last, it times each kernel against its plain
version and the main path's iterations per second.

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Each phase prints one line; any failure exits non-zero. The last three
lines are the kernels' JSON summary, the card as ``nvidia-smi`` names it,
and ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ssspy_tpu_torch import separate as separate_waveform
from ssspy_tpu_torch.algorithm import projection_back
from ssspy_tpu_torch.bss.iva import AuxLaplaceIVA
from ssspy_tpu_torch.fast import fast_auxiva
from ssspy_tpu_torch.ops import _build
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops.iva_steps import auxiva_ip1_step, iva_laplace_loss, separate
from ssspy_tpu_torch.special.flooring import F32_EPS
from ssspy_tpu_torch.transform import istft, stft
from ssspy_tpu_torch.utils.dataset import HOP, N_FFT, make_mixture

N_ITER = 100
FAST_EPS = 1e-10  # fast_auxiva / auxiva_ip1_step default
WCOV_TOL = 1e-5  # both sides sum 626 f32 terms, in different orders
SWEEP_TOL = 1e-4
LOSS_TOL = 1e-3
MIN_SI_SDR_DB = 30.0
N_TIMED = 30  # timed runs per measurement, after warm-up
SILENT_BINS = (0, 128)
SPIN_CYCLES = 20_000_000  # ~10 ms of device spin ahead of a "queued" timing

KERNELS = {
    "weighted_covariance": {
        "source": "ssspy_tpu_torch/ops/csrc/weighted_covariance.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:155",
    },
    "ip1_sweep": {
        "source": "ssspy_tpu_torch/ops/csrc/ip1_sweep.cu",
        "replaces": "ssspy_tpu/ops/splitc.py:281",
    },
}


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


def check(condition, message: str) -> None:
    if not condition:
        fail(message)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def all_finite(*tensors) -> bool:
    return all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()) for t in tensors)


def si_sdr_db(est: np.ndarray, ref: np.ndarray) -> float:
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    with np.errstate(divide="ignore", invalid="ignore"):  # identical signals: +inf dB
        return float(10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err))))


def min_si_sdr(est: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst per-source SI-SDR of ``est`` against ``ref`` (sources on axis 0), in float64."""
    est = est.cpu().numpy().astype(np.complex128)
    ref = ref.cpu().numpy().astype(np.complex128)
    return min(si_sdr_db(est[n], ref[n]) for n in range(est.shape[0]))


def median_ms(fn, queued: bool, n_runs: int = N_TIMED, n_warmup: int = 3) -> float:
    """Median time of ``fn()`` between two CUDA events, over ``n_runs`` runs.

    ``queued=False``: the device starts idle, so the time includes every
    gap in which it waits for the host to enqueue ``fn``'s launches (what
    a caller pays per call). ``queued=True``: the device is first kept busy
    with a spin kernel long enough for the host to enqueue the events and
    all of ``fn``'s launches, so the time is the device's own, from the
    first to the last launch of ``fn``.
    """
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def plain_iterations(X, n_iter, varphi_of, eps):
    """The main-path iteration through the plain versions (LU solve)."""
    W = torch.eye(X.shape[0], dtype=X.dtype, device=X.device).expand(X.shape[1], -1, -1).contiguous()
    for _ in range(n_iter):
        U = K.weighted_covariance_plain(X, varphi_of(separate(X, W)))
        W = K.ip1_sweep_plain(W, U, eps, solve_impl="lu")
    return W


def fast_varphi(Y):
    return 1.0 / torch.clamp(torch.linalg.vector_norm(Y, dim=1), min=FAST_EPS)


def class_varphi(Y):
    # AuxLaplaceIVA: G'(r) / flooring(2r) with the complex64 "dtype" floor
    return 2.0 / torch.clamp(2 * torch.linalg.vector_norm(Y, dim=1), min=F32_EPS)


def main() -> None:
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    nvcc =subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    nvcc_version = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else "unknown"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(
        "device", name=repr(kind), nvidia_smi=repr(card), count=torch.cuda.device_count(),
        driver=repr(driver), torch=torch.__version__, cuda=torch.version.cuda, nvcc=repr(nvcc_version),
        python=sys.version.split()[0],
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )

    # ---- 2. build -----------------------------------------------------------
    start = time.perf_counter()
    for name in KERNELS:
        _build.load(name)
    build_s = time.perf_counter() - start
    ptxas = {
        name: " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in _build.build_info[name]["log"].splitlines()
            if "Used" in line or "spill" in line
        )
        for name in KERNELS
    }
    say("build", seconds=f"{build_s:.3f}", **{f"{k}_seconds": f"{v['seconds']:.3f}" for k, v in _build.build_info.items()})
    for name, info in ptxas.items():
        say("build", kernel=name, ptxas=repr(info))

    # main-path input, made on the host from a seed and transformed on the card
    wave = torch.from_numpy(make_mixture(seed=0)).to(device=device, dtype=torch.float32)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP)
    check(tuple(X.shape) == (8, 257, 626) and X.dtype == torch.complex64, f"main-path STFT {tuple(X.shape)} {X.dtype}")
    M, I, T = X.shape
    rng = np.random.default_rng(0)
    W_eye = torch.eye(M, dtype=X.dtype, device=device).expand(I, -1, -1).contiguous()
    errors = {}

    # ---- 3. K1 against its plain version --------------------------------------
    phi_scalar = fast_varphi(separate(X, W_eye)).contiguous()
    phi_bins = torch.from_numpy(rng.random((M, I, T), dtype=np.float32) + 0.1).to(device)
    wcov_abs = 0.0
    for label, phi in (("scalar (N,T)", phi_scalar), ("per-bin (N,I,T)", phi_bins)):
        U = K.weighted_covariance(X, phi)
        U_ref = K.weighted_covariance_plain(X, phi)
        torch.cuda.synchronize()
        abs_err = float((U - U_ref).abs().max())
        rel_err = abs_err / float(U_ref.abs().max())
        hermitian = float((U - U.transpose(-2, -1).conj()).abs().max())
        say("K1 weighted_covariance", weights=repr(label), shape=(M, M, I, T), max_abs_err=abs_err,
            rel_err=rel_err, tol=WCOV_TOL, hermitian_err=hermitian)
        check(rel_err <= WCOV_TOL and all_finite(U), f"weighted_covariance {label}: rel err {rel_err}")
        wcov_abs = max(wcov_abs, abs_err)
    errors["weighted_covariance"] = wcov_abs

    # ---- 4. K1b against its exact twin (gjnp) ----------------------------------
    U = K.weighted_covariance(X, phi_scalar)
    U[list(SILENT_BINS)] = 0
    noise = rng.standard_normal((2, I, M, M)).astype(np.float32)
    W0 = W_eye + 0.1 * torch.complex(torch.from_numpy(noise[0]), torch.from_numpy(noise[1])).to(device)
    W_new = K.ip1_sweep(W0, U, eps=FAST_EPS)
    W_ref = K.ip1_sweep_plain(W0, U, eps=FAST_EPS, solve_impl="gjnp")
    torch.cuda.synchronize()
    live = [i for i in range(I) if i not in SILENT_BINS]
    frozen = all(torch.equal(W_new[i], W0[i]) for i in SILENT_BINS)
    sweep_abs = float((W_new[live] - W_ref[live]).abs().max())
    sweep_rel = sweep_abs / float(W_ref[live].abs().max())
    say("K1b ip1_sweep", shape=(I, M, M), silent_bins=SILENT_BINS, frozen_unchanged=frozen,
        max_abs_err=sweep_abs, rel_err=sweep_rel, tol=SWEEP_TOL)
    check(frozen, "ip1_sweep changed a row of a silent (U = 0) bin")
    check(sweep_rel <= SWEEP_TOL and all_finite(W_new), f"ip1_sweep: rel err {sweep_rel}")
    errors["ip1_sweep"] = sweep_abs

    # ---- 5. main path ----------------------------------------------------------
    torch.cuda.synchronize()
    K.weighted_covariance.launches = 0
    K.ip1_sweep.launches = 0
    iva = AuxLaplaceIVA(spatial_algorithm="IP")
    Y_class = iva(X, n_iter=N_ITER)
    Y_fast, W_fast = fast_auxiva(X, n_iter=N_ITER, algorithm="IP1")
    y_wave = separate_waveform(wave, AuxLaplaceIVA(spatial_algorithm="IP"), n_iter=N_ITER,
                               n_fft=N_FFT, hop_length=HOP)
    torch.cuda.synchronize()
    launches = {"weighted_covariance": K.weighted_covariance.launches, "ip1_sweep": K.ip1_sweep.launches}
    say("main path", launches=launches, class_shape=tuple(Y_class.shape), wave_shape=tuple(y_wave.shape))
    for name, count in launches.items():
        check(count >= N_ITER, f"the main path launched {name} {count} times (< {N_ITER})")
    check(all_finite(Y_class, Y_fast, W_fast, y_wave), "non-finite main-path output")
    check(tuple(Y_class.shape) == tuple(Y_fast.shape) == (M, I, T), "separated spectrogram shape")
    check(tuple(y_wave.shape) == tuple(wave.shape), "separated waveform shape")
    check(len(iva.loss) == N_ITER + 1 and iva.loss[-1] < iva.loss[0],
          f"class loss did not decrease: {iva.loss[0]} -> {iva.loss[-1]}")

    # the same iterations through the plain versions, on the card
    W_plain_class = plain_iterations(X, N_ITER, class_varphi, F32_EPS)
    W_plain_fast = plain_iterations(X, N_ITER, fast_varphi, FAST_EPS)
    loss_plain_class = float(iva_laplace_loss(X, W_plain_class))
    loss_rel = abs(iva.loss[-1] - loss_plain_class) / abs(loss_plain_class)
    Y_plain_class = separate(X, projection_back(W_plain_class, reference_id=0))
    sdr_class = min_si_sdr(Y_class, Y_plain_class)
    say("main path: AuxLaplaceIVA(IP)", loss_first=iva.loss[0], loss_last=iva.loss[-1],
        plain_loss_last=loss_plain_class, loss_rel_diff=loss_rel, min_si_sdr_db=sdr_class)
    check(loss_rel <= LOSS_TOL, f"class loss {iva.loss[-1]} vs plain {loss_plain_class}")
    check(sdr_class >= MIN_SI_SDR_DB, f"class output vs plain: {sdr_class:.2f} dB")

    W_plain_fast = W_plain_fast * torch.linalg.inv_ex(W_plain_fast)[0][:, 0, :, None]
    loss_fast, loss_plain_fast = float(iva_laplace_loss(X, W_fast)), float(iva_laplace_loss(X, W_plain_fast))
    fast_rel = abs(loss_fast - loss_plain_fast) / abs(loss_plain_fast)
    sdr_fast = min_si_sdr(Y_fast, separate(X, W_plain_fast))
    say("main path: fast_auxiva(IP1)", loss=loss_fast, plain_loss=loss_plain_fast,
        loss_rel_diff=fast_rel, min_si_sdr_db=sdr_fast)
    check(fast_rel <= LOSS_TOL, f"fast_auxiva loss {loss_fast} vs plain {loss_plain_fast}")
    check(sdr_fast >= MIN_SI_SDR_DB, f"fast_auxiva output vs plain: {sdr_fast:.2f} dB")

    y_plain = istft(Y_plain_class, n_fft=N_FFT, hop_length=HOP, length=wave.shape[-1])
    sdr_wave = min_si_sdr(y_wave, y_plain)
    say("main path: separate (waveform)", min_si_sdr_db=sdr_wave)
    check(sdr_wave >= MIN_SI_SDR_DB, f"pipeline output vs plain: {sdr_wave:.2f} dB")

    # ---- 6. times --------------------------------------------------------------
    U_main = K.weighted_covariance(X, phi_scalar)
    timed = {
        "weighted_covariance": (
            lambda: K.weighted_covariance(X, phi_scalar),
            lambda: K.weighted_covariance_plain(X, phi_scalar),
        ),
        "ip1_sweep": (
            lambda: K.ip1_sweep(W_eye, U_main),
            lambda: K.ip1_sweep_plain(W_eye, U_main, solve_impl="lu"),
        ),
    }
    timings = {}
    for name, (kernel_fn, plain_fn) in timed.items():
        ms, plain_ms = median_ms(kernel_fn, queued=True), median_ms(plain_fn, queued=True)
        call_ms, plain_call_ms = median_ms(kernel_fn, queued=False), median_ms(plain_fn, queued=False)
        timings[name] = (ms, plain_ms)
        say("time", kernel=name, card=repr(card), device_ms=ms, plain_device_ms=plain_ms,
            call_ms=call_ms, plain_call_ms=plain_call_ms, runs=N_TIMED, stat="median")
    gjnp_ms = median_ms(lambda: K.ip1_sweep_plain(W_eye, U_main, solve_impl="gjnp"), queued=True)
    say("time", kernel="ip1_sweep", card=repr(card), plain_gjnp_device_ms=gjnp_ms, runs=N_TIMED, stat="median")

    def iterations(step):
        W = W_eye
        for _ in range(N_ITER):
            W = step(W)
        return W

    def rate(step) -> float:
        iterations(step)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        iterations(step)
        end.record()
        torch.cuda.synchronize()
        return N_ITER / (start.elapsed_time(end) / 1e3)

    kernel_rate = rate(lambda W: auxiva_ip1_step(X, W))
    plain_rate = rate(lambda W: K.ip1_sweep_plain(
        W, K.weighted_covariance_plain(X, fast_varphi(separate(X, W))), FAST_EPS, solve_impl="lu"))
    say("time", path="AuxIVA-IP1 8ch 10s, 100 iterations (fast_auxiva step)", card=repr(card),
        kernels_iters_per_s=kernel_rate, plain_iters_per_s=plain_rate)

    # where the device time of one main-path iteration goes (torch.profiler)
    n_profiled = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        W = W_eye
        for _ in range(n_profiled):
            W = auxiva_ip1_step(X, W)
        torch.cuda.synchronize()
    per_kernel = {}
    for event in prof.events():
        if event.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[event.name] = per_kernel.get(event.name, 0.0) + event.time_range.elapsed_us()
    device_us = sum(per_kernel.values()) / n_profiled
    check(device_us > 0, "the profiler saw no device time in the main-path iterations")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    say("profile", card=repr(card), device_us_per_iter=device_us,
        device_busy_share=device_us * 1e-6 * kernel_rate,
        top=repr([(name[:48], round(us / n_profiled, 3)) for name, us in top]))

    summary = [
        {
            "name": name,
            "route": "cuda",
            "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": timings[name][0],
            "plain_ms": timings[name][1],
        }
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
