"""The multi-device dry run: the runners over ``n`` spawned ranks, each held against itself on one rank.

Twin of ``__graft_entry__.dryrun_multichip`` (__graft_entry__.py:73-268):
:func:`dryrun_multichip` spawns ``n`` ranks, lays them out with
:func:`~ssspy_tpu_torch.parallel.make_layout` and runs 2 steps of each of
the six state layouts the JAX dry run drives (AuxIVA-IP1, AuxIVA-ISS1,
GaussILRMA-IP1, masked dense GaussMNMF, cACGMM, GaussIPSDTA) at its shapes,
257 bins where it takes them, so that the bins do not divide over the
ranks. Each rank holds every sharded result against the same runner at
world size 1 on its own device, within the JAX dry run's tolerances.
GaussILRMA's and FastGaussMNMF's power normalizations average over the
padded bins, so their world-1 runs take the same padded inputs (padded
against padded, as the JAX dry run compares them).

:data:`CASES` also holds every other runner (AuxIVA IP2, ISS2 and IPA, the
waveform runner, dense GaussMNMF with partitioning, FastIVA, FasterIVA,
AuxFDICA IP1 and IP2, GradIVA, GradFDICA, FastGaussMNMF, PDSIVA, ADMMIVA,
HVA and time-domain ICA: 22 cases), and :func:`dryrun_multichip` also
takes inputs the caller gives; :func:`spawn` starts the ranks of any
function.
``python -m ssspy_tpu_torch.parallel.dryrun 4 --device cpu`` runs the dry
run, ``--all`` every case.
"""

import argparse
import contextlib
import json
import multiprocessing
import queue as queue_module
import socket
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import (
    make_batched_admm_iva_runner,
    make_batched_auxiva_ip2_runner,
    make_batched_auxiva_ipa_runner,
    make_batched_auxiva_iss1_runner,
    make_batched_auxiva_iss2_runner,
    make_batched_auxiva_runner,
    make_batched_auxiva_wave_runner,
    make_batched_cacgmm_runner,
    make_batched_fast_iva_runner,
    make_batched_fast_mnmf_runner,
    make_batched_faster_iva_runner,
    make_batched_fdica_runner,
    make_batched_gauss_mnmf_runner,
    make_batched_grad_fdica_runner,
    make_batched_grad_iva_runner,
    make_batched_hva_runner,
    make_batched_ica_runner,
    make_batched_ilrma_runner,
    make_batched_ipsdta_runner,
    make_batched_pds_iva_runner,
    make_layout,
)
from ..ops import kernels
from ..ops.fixed_point_iva_steps import fast_iva_laplace_loss
from ..ops.iva_steps import iva_laplace_loss

__all__ = ["Case", "CASES", "DRYRUN_CASES", "make_inputs", "run_case", "spawn", "dryrun_multichip"]

N_STEPS = 2
KERNELS = ("weighted_covariance", "ip1_sweep", "iss1_sweep", "jacobi_eigh", "ipa_congruence", "gj_inverse",
           "inv_sandwich", "model_traces")


# ---- the inputs, from a numpy seed -------------------------------------------------------------


def _cplx(rng, shape, real):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.result_type(real, 1j))


def _eye(shape, dtype):
    return np.broadcast_to(np.eye(shape[-1], dtype=dtype), shape).copy()


def _whitened(X: np.ndarray) -> np.ndarray:
    """Each bin of ``X (B, M, I, T)`` whitened: ``Lambda^-1/2 Gamma^H x`` from the eigh of ``mean_t x x^H``."""
    C = np.einsum("bmit,bnit->bimn", X, X.conj()) / X.shape[-1]
    lamb, G = np.linalg.eigh(C)
    return np.einsum("bimk,bmit->bkit", G.conj(), X) / np.sqrt(lamb).transpose(0, 2, 1)[..., None]


def _spectral_normalized(X: np.ndarray) -> np.ndarray:
    """``X (B, M, I, T)`` over its largest spectral norm of a bin, the prox family's step-size scaling."""
    return X / np.linalg.norm(X.transpose(0, 2, 1, 3), ord=2, axis=(-2, -1)).max()


def make_inputs(name: str, n_batch: int = 2, n_bins: int = 257, real=np.float32) -> tuple:
    """The global inputs of runner ``name``: numpy arrays, utterances on axis 0, made from seed 0.

    The shapes of the JAX dry run (__graft_entry__.py:36-45, :144-248):
    3 channels and sources, 32 frames and 2 bases over
    ``n_bins`` bins for the IVA, ILRMA and cACGMM runners; dense GaussMNMF
    takes 33 bins and 8 frames (the JAX dry run's), or ``n_bins`` where that
    is less; GaussIPSDTA 8 frames and blocks of 4 bins, as many as fit in
    ``min(n_bins, 32)`` (32 bins, 8 blocks, the JAX dry run's); the waveform
    runner ``(B, M, 2048)`` samples at ``n_fft = 256``. The runners of the
    other families take the IVA shapes: FastIVA and FasterIVA the mixture
    whitened per bin, PDSIVA, ADMMIVA and HVA the mixture over its largest
    spectral norm of a bin (their step-size condition) with zero duals,
    FastGaussMNMF 2 bases and loadings of 0.1 to 1.1, and time-domain ICA
    ``(B, M, 2048)`` Laplace samples.
    ``real`` is the real dtype (complex inputs take its complex type).
    """
    rng = np.random.default_rng(0)
    M, K, T = 3, 2, 32
    cdt = np.result_type(real, 1j)
    if name == "wave":
        return (rng.standard_normal((n_batch, M, 2048)).astype(real),)
    if name in ("ip1", "ip2", "fdica_ip1", "fdica_ip2", "grad_iva", "grad_fdica"):
        return _cplx(rng, (n_batch, M, n_bins, T), real), _eye((n_batch, n_bins, M, M), cdt)
    if name in ("fast_iva", "faster_iva"):
        Z = _whitened(_cplx(rng, (n_batch, M, n_bins, T), np.float64)).astype(cdt)
        return Z, _eye((n_batch, n_bins, M, M), cdt)
    if name in ("pds_iva", "hva", "admm_iva"):
        X = _spectral_normalized(_cplx(rng, (n_batch, M, n_bins, T), np.float64)).astype(cdt)
        W, Y = _eye((n_batch, n_bins, M, M), cdt), np.zeros((n_batch, M, n_bins, T), cdt)
        if name != "admm_iva":
            return X, (W, Y)
        return X, (W, W.copy(), Y, np.zeros_like(W), Y.copy())
    if name == "fast_mnmf":
        X = _cplx(rng, (n_batch, M, n_bins, T), real)
        T_ = (rng.random((n_batch, M, n_bins, K)) + 0.1).astype(real)
        V_ = (rng.random((n_batch, M, K, T)) + 0.1).astype(real)
        D_ = (rng.random((n_batch, n_bins, M, M)) + 0.1).astype(real)
        return X, (_eye((n_batch, n_bins, M, M), cdt), T_, V_, D_)
    if name == "ica":
        return rng.laplace(size=(n_batch, M, 2048)).astype(real), _eye((n_batch, M, M), real)
    if name in ("iss1", "iss2", "ipa"):
        return (_cplx(rng, (n_batch, M, n_bins, T), real),)
    if name == "ilrma":
        X = _cplx(rng, (n_batch, M, n_bins, T), real)
        T_ = (rng.random((n_batch, M, n_bins, K)) + 0.1).astype(real)
        V_ = (rng.random((n_batch, M, K, T)) + 0.1).astype(real)
        return X, (_eye((n_batch, n_bins, M, M), cdt), T_, V_)
    if name in ("mnmf", "mnmf_partitioning"):
        I, Tf = min(n_bins, 33), 8
        Xc = _cplx(rng, (n_batch, M, I, Tf), real)
        XX = np.einsum("bmit,bnit->bitmn", Xc, Xc.conj()).astype(cdt)
        H = (_eye((n_batch, M, I, M, M), real) + 0.1).astype(cdt)
        if name == "mnmf":
            T_ = (rng.random((n_batch, M, I, K)) + 0.1).astype(real)
            V_ = (rng.random((n_batch, M, K, Tf)) + 0.1).astype(real)
            return XX, (T_, V_, H)
        T_ = (rng.random((n_batch, I, K)) + 0.1).astype(real)
        V_ = (rng.random((n_batch, K, Tf)) + 0.1).astype(real)
        Z = rng.random((n_batch, M, K))
        return XX, (T_, V_, H, (Z / Z.sum(axis=1, keepdims=True)).astype(real))
    if name == "cacgmm":
        Z = _cplx(rng, (n_batch, M, n_bins, T), real)
        Z = (Z / np.maximum(np.linalg.norm(Z, axis=1, keepdims=True), 1e-10)).astype(cdt)
        alpha = rng.random((n_batch, M, n_bins))
        alpha = (alpha / alpha.sum(axis=1, keepdims=True)).astype(real)
        B = (rng.random((n_batch, M, n_bins, M))[..., None] * np.eye(M)).astype(cdt)
        return Z, (alpha, B)
    if name == "ipsdta":
        J = 4
        n_blocks = max(1, min(n_bins, 32) // J)
        I, Tf = n_blocks * J, 8
        X = _cplx(rng, (n_batch, M, I, Tf), real)
        T_ = (rng.random((n_batch, M, K, n_blocks, J))[..., None] * np.eye(J)).astype(cdt)
        V_ = (rng.random((n_batch, M, K, Tf)) + 0.1).astype(real)
        return X, (_eye((n_batch, I, M, M), cdt), [T_], V_)
    raise ValueError(f"unknown runner {name!r}")


# ---- the cases ---------------------------------------------------------------------------------


@dataclass(frozen=True)
class Case:
    """A runner of the slice: its factory, how it is called, its tolerance and its all-reduces per iteration.

    ``tol``: the tolerance of the runner against its run at world size 1
    in float32, on ``measure``: ``"abs"``, the largest absolute error of
    any output (the JAX dry run's and tests' tolerances,
    __graft_entry__.py:144-268, tests/parallel/test_sharding.py); ``"rel"``,
    that error over the reference's largest magnitude (IP2 and ISS2, whose
    outputs reach 12 and 28 here, where the JAX tests' data reach 1-4);
    ``"loss"``, the largest relative difference of the per-utterance
    AuxIVA loss (IPA: one float32 sweep turns a relative 1e-7 on its input
    into an O(1) change of the output, in the JAX package as well, whose
    sharded test runs IPA in float64; chip_smoke.py holds its IPA paths on
    the loss for the same reason, with this tolerance); ``"whitened_loss"``,
    the same on FastIVA's whitened Laplace loss (FasterIVA: the phase that
    the top eigenvector takes in a bin whose largest components nearly tie
    flips under float32 summation-order noise, as the JAX package's sharded
    test notes, tests/parallel/test_sharding.py:506-511, and the phase
    moves no loss). ``pin``: all-reduces per iteration
    through the bin hook with the bins split
    (tests/parallel/test_hlo_collectives.py:241-262), but HVA's: 1 where the
    JAX package pins 2, since its runner gathers the floored log magnitude
    once and runs the whole-axis mask on cuFFT where the JAX runner's DFT
    matmuls all-reduce twice (``make_batched_hva_runner``); ``extra``: those
    issued once, after the loop (the waveform runner's bin gather).
    ``launches``: each kernel's launches per iteration on a card that runs
    two utterances, the dry run's local batch at every layout (the steps
    fold the utterances into the bins or loop over them, and a rank's
    share of the bins moves no count).
    """

    factory: Callable
    call: str
    tol: float
    pin: int
    measure: str = "abs"
    extra: int = 0
    launches: Mapping[str, int] = field(default_factory=dict)


# sequential pairs of 3 sources: 3 (AuxIVA-IP2's pin at 3 channels)
# launches per iteration at two utterances: K1 once per utterance (and per pair of IP2's three), K1b once for both
# (folded into the bins), K2 once per utterance, K5 once per utterance and model pass (three, four with
# partitioning), K6 and K7 once per utterance and source in IPA's sweep, K7 twice for both in dense MNMF (the
# geometric mean and the spatial floor) and cACGMM (the E- and the M-step) and once in IPSDTA (the geometric mean),
# K3 three times for both
CASES: Dict[str, Case] = {
    "ip1": Case(make_batched_auxiva_runner, "batched", 1e-5, 1,
                launches={"weighted_covariance": 2, "ip1_sweep": 1}),
    "iss1": Case(make_batched_auxiva_iss1_runner, "state", 1e-5, 1, launches={"iss1_sweep": 2}),
    "ilrma": Case(make_batched_ilrma_runner, "pytree", 1e-4, 2, launches={"weighted_covariance": 2, "ip1_sweep": 1}),
    "mnmf": Case(make_batched_gauss_mnmf_runner, "pytree", 2e-3, 1, launches={"jacobi_eigh": 2, "model_traces": 6}),
    "cacgmm": Case(make_batched_cacgmm_runner, "pytree", 1e-5, 0, launches={"jacobi_eigh": 2}),
    "ipsdta": Case(make_batched_ipsdta_runner, "pytree", 2e-3, 1, launches={"jacobi_eigh": 1, "gj_inverse": 3}),
    "ip2": Case(make_batched_auxiva_ip2_runner, "batched", 5e-4, 3, measure="rel",
                launches={"weighted_covariance": 6}),
    "iss2": Case(make_batched_auxiva_iss2_runner, "state", 3e-4, 1, measure="loss"),
    "ipa": Case(make_batched_auxiva_ipa_runner, "state", 3e-4, 1, measure="loss",
                launches={"weighted_covariance": 2, "jacobi_eigh": 6, "ipa_congruence": 6}),
    "wave": Case(lambda layout: make_batched_auxiva_wave_runner(layout, n_fft=256), "wave", 1e-4, 1, extra=1,
                 launches={"weighted_covariance": 2, "ip1_sweep": 1}),
    "mnmf_partitioning": Case(lambda layout: make_batched_gauss_mnmf_runner(layout, partitioning=True),
                              "pytree", 2e-3, 2, launches={"jacobi_eigh": 2, "model_traces": 8}),
    # K7 once for both utterances (the polar factor); FasterIVA K1 once per utterance and K7 twice for both (the
    # top eigenvectors, the polar factor); FDICA-IP1 K1 once per utterance and K1b once for both, IP2 K1 once per
    # utterance and pair; FastGaussMNMF K1 once per utterance and K1b once for both; the prox family K7 once for
    # both (the log-det prox); the gradient runners and ICA no kernel
    "fast_iva": Case(make_batched_fast_iva_runner, "batched", 1e-5, 1, launches={"jacobi_eigh": 1}),
    "faster_iva": Case(make_batched_faster_iva_runner, "batched", 1e-5, 1, measure="whitened_loss",
                       launches={"weighted_covariance": 2, "jacobi_eigh": 2}),
    "fdica_ip1": Case(make_batched_fdica_runner, "batched", 1e-5, 0,
                      launches={"weighted_covariance": 2, "ip1_sweep": 1}),
    "fdica_ip2": Case(lambda layout: make_batched_fdica_runner(layout, spatial_algorithm="IP2"), "batched", 1e-5, 0,
                      launches={"weighted_covariance": 6}),
    "grad_iva": Case(make_batched_grad_iva_runner, "batched", 1e-5, 1),
    "grad_fdica": Case(make_batched_grad_fdica_runner, "batched", 1e-5, 0),
    "fast_mnmf": Case(make_batched_fast_mnmf_runner, "pytree", 1e-4, 2,
                      launches={"weighted_covariance": 2, "ip1_sweep": 1}),
    "pds_iva": Case(make_batched_pds_iva_runner, "pytree", 1e-5, 1, launches={"jacobi_eigh": 1}),
    "admm_iva": Case(make_batched_admm_iva_runner, "pytree", 1e-5, 1, launches={"jacobi_eigh": 1}),
    "hva": Case(make_batched_hva_runner, "pytree", 1e-5, 1, launches={"jacobi_eigh": 1}),
    "ica": Case(make_batched_ica_runner, "batched", 1e-5, 0),
}
# the six state layouts of the JAX dry run
DRYRUN_CASES = ("ip1", "iss1", "ilrma", "mnmf", "cacgmm", "ipsdta")


def _pad_bins(a: np.ndarray, axis: int, n: int, identity: bool = False) -> np.ndarray:
    """``a`` with its bin axis padded to ``n`` entries: zeros, or identity filters."""
    pad = n - a.shape[axis]
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    out = np.pad(a, widths)
    if identity and pad:
        index = [slice(None)] * a.ndim
        index[axis] = slice(a.shape[axis], n)
        out[tuple(index)] = np.eye(a.shape[-1], dtype=a.dtype)
    return out


# the runners whose normalization averages over the padded bins, compared padded against padded: each carry leaf's
# bin axis (None: none) and whether it is identity-padded
PADDED = {"ilrma": ((1, True), (2, False), (None, False)),
          "fast_mnmf": ((1, True), (2, False), (None, False), (1, False))}


def padded_inputs(name: str, inputs: tuple, shards: int) -> tuple:
    """The inputs of a :data:`PADDED` runner padded as a run over ``shards`` bin shards pads them (X zeros)."""
    if name not in PADDED or shards == 1:
        return inputs
    X, carry = inputs
    n = -(-X.shape[2] // shards) * shards
    return _pad_bins(X, 2, n), tuple(
        leaf if axis is None else _pad_bins(leaf, axis, n, identity=identity)
        for leaf, (axis, identity) in zip(carry, PADDED[name])
    )


def run_case(name: str, layout, inputs: tuple, n_iter: int = N_STEPS) -> Tuple[torch.Tensor, ...]:
    """Runner ``name`` over ``layout`` on ``inputs`` (:func:`make_inputs`); its outputs as a flat tuple of tensors."""
    run = CASES[name].factory(layout)
    call = CASES[name].call
    if call == "batched":
        return (run(inputs[0], inputs[1], n_iter),)
    if call in ("state", "wave"):
        return (run(inputs[0], n_iter),)
    out = run(inputs[0], inputs[1], n_iter)
    if name == "ipsdta":
        W, (T_,), V_ = out
        return W, T_, V_
    return tuple(out)


def reference_case(name: str, inputs: tuple, shards: int, device, n_iter: int = N_STEPS) -> Tuple[torch.Tensor, ...]:
    """Runner ``name`` at world size 1 on ``device``: the reference a run over ``shards`` bin shards is held to."""
    out = run_case(name, make_layout(world_size=1, device=device), padded_inputs(name, inputs, shards), n_iter)
    if name in PADDED and shards > 1:
        n_bins = inputs[0].shape[2]
        return tuple(o if axis is None else o.narrow(axis, 0, n_bins) for o, (axis, _) in zip(out, PADDED[name]))
    return out


# ---- ranks -------------------------------------------------------------------------------------


def free_port() -> int:
    """A free TCP port on localhost, for ``init_process_group``'s ``tcp://localhost:<port>``."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, device, fn, args, results):
    try:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:
            torch.set_num_threads(1)  # the ranks share the host's cores
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world_size, rank=rank)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises; the rank then exits non-zero
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(world_size: int, fn: Callable, args: Sequence = (), device="cpu", backend: Optional[str] = None,
          timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks under one process group; the ranks' results in rank order.

    ``fn`` must be importable and return what pickles by value (numpy
    arrays, numbers). ``backend`` defaults to gloo on the CPU and, on the
    card, to NCCL when every rank has a card of its own and gloo when ranks
    share one (NCCL refuses two ranks on one device). Rank ``r`` on the
    card takes card ``r`` modulo their number. Any rank's failure raises
    here with its traceback; every rank is stopped before this returns.
    """
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" and world_size <= torch.cuda.device_count() else "gloo"
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [
        ctx.Process(target=_rank_main, args=(rank, world_size, port, backend, str(device), fn, tuple(args), results))
        for rank in range(world_size)
    ]
    for proc in procs:
        proc.start()
    gathered, failures = {}, []
    try:
        for _ in range(world_size):
            rank, ok, out = results.get(timeout=timeout)
            (gathered.__setitem__(rank, out) if ok else failures.append(f"rank {rank}:\n{out}"))
            if not ok:
                break
    except queue_module.Empty:
        failures.append(f"no result within {timeout} s")
    finally:
        for proc in procs:
            proc.join(timeout=30 if not failures else 5)
            if proc.is_alive():
                proc.kill()
                proc.join()
    if failures:
        raise RuntimeError(f"{world_size} {backend} ranks failed:\n" + "\n".join(failures))
    return [gathered[rank] for rank in range(world_size)]


def error(name: str, inputs: tuple, out: torch.Tensor, ref: torch.Tensor, measure: Optional[str] = None) -> float:
    """``out`` against ``ref`` on case ``name``'s measure (:class:`Case`), or on ``measure``."""
    measure = measure or CASES[name].measure
    if measure in ("loss", "whitened_loss"):
        X = torch.as_tensor(inputs[0]).to(ref.device)
        loss = ((lambda x, y: iva_laplace_loss(x, Y=y)) if measure == "loss"
                else (lambda z, w: fast_iva_laplace_loss(z, w)))
        losses = [(loss(X[b], out[b]), loss(X[b], ref[b])) for b in range(X.shape[0])]
        return max(float((a - b).abs() / b.abs()) for a, b in losses)
    err = float((out - ref).abs().max())
    return err / float(ref.abs().max()) if measure == "rel" else err


def _launches() -> Dict[str, int]:
    return {name: getattr(kernels, name).launches for name in KERNELS}


@contextlib.contextmanager
def _recording(calls: list):
    """Append ``(kernel, args, kwargs)`` of every kernel wrapper call, its tensors copied; the wrappers still run.

    The steps reach each wrapper through its attribute of
    :mod:`ssspy_tpu_torch.ops.kernels`, so the recorder takes that place.
    A wrapper counts its launches on the function its module attribute
    names, the recorder while it records: the recorder starts from the
    wrapper's count and hands the count back when it is taken away.
    """
    wrappers = {name: getattr(kernels, name) for name in KERNELS}

    def recorder(name, wrapper):
        def record(*args, **kwargs):
            calls.append((name, [a.clone() if torch.is_tensor(a) else a for a in args], kwargs))
            return wrapper(*args, **kwargs)

        record.launches = wrapper.launches
        return record

    for name, wrapper in wrappers.items():
        setattr(kernels, name, recorder(name, wrapper))
    try:
        yield
    finally:
        for name, wrapper in wrappers.items():
            wrapper.launches = getattr(kernels, name).launches
            setattr(kernels, name, wrapper)


def _held(name: str, args: list, kwargs: dict) -> float:
    """Kernel ``name`` against its plain version on one recorded input: the largest error over the plain output's
    largest magnitude, 0 where the two agree to the bit.

    K1b's plain version takes the kernel's exact elimination (``gjnp``);
    K5 is held on the bins whose ``XX`` is not zero (a masked, zero-padded
    bin's floors are held where chip_smoke.py tests that edge).
    """
    got = getattr(kernels, name)(*args, **kwargs)
    plain_kwargs = dict(kwargs, solve_impl="gjnp") if name == "ip1_sweep" else kwargs
    ref = getattr(kernels, f"{name}_plain")(*args, **plain_kwargs)
    got, ref = ((o,) if torch.is_tensor(o) else tuple(o) for o in (got, ref))
    if name == "model_traces":
        real = args[2].flatten(1).abs().amax(dim=1) > 0
        got, ref = ([o[:, real] for o in outs] for outs in (got, ref))
    return max(0.0 if torch.equal(g, r) else float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def _rank_cases(names: Sequence[str], device: str, hold_kernels: bool, given: Optional[Mapping[str, tuple]],
                n_iter: int, measure: Optional[str]) -> dict:
    """One rank's share of the dry run: every case sharded, then at world size 1; the errors and counts.

    With ``hold_kernels`` every kernel call of the sharded run is recorded
    and held against its plain version (:func:`_held`) at the rank's own
    shapes: per kernel, the calls held and the largest error.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    layout = make_layout(device=device)
    report = {"shape": layout.shape, "rank": layout.rank, "cases": {}}
    for name in names:
        inputs = given[name] if given else make_inputs(name, n_batch=2 * layout.shape[0])
        calls, held = [], {}
        before = _launches()
        all_reduces = 0 if layout.bin_sum is None else layout.bin_sum.calls
        with _recording(calls) if hold_kernels else contextlib.nullcontext():
            out = run_case(name, layout, inputs, n_iter)
        all_reduces = (0 if layout.bin_sum is None else layout.bin_sum.calls) - all_reduces
        launches = {k: v - before[k] for k, v in _launches().items()}
        for kernel, args, kwargs in calls:
            n_held, worst = held.get(kernel, (0, 0.0))
            held[kernel] = (n_held + 1, max(worst, _held(kernel, args, kwargs)))
        ref = reference_case(name, inputs, layout.shape[1], layout.device, n_iter)
        errors = [error(name, inputs, o, r, measure) for o, r in zip(out, ref)]
        finite = all(bool(torch.isfinite(torch.view_as_real(o) if o.is_complex() else o).all()) for o in out)
        report["cases"][name] = {
            "max_abs_err": max(errors), "finite": finite,
            "shapes": [tuple(o.shape) for o in out], "ref_shapes": [tuple(r.shape) for r in ref],
            "bin_sum_calls": all_reduces, "launches": launches, "held": held,
        }
    return report


def dryrun_multichip(n_ranks: int, device="cuda", names: Sequence[str] = DRYRUN_CASES,
                     backend: Optional[str] = None, kernel_tols: Optional[Mapping[str, float]] = None,
                     inputs: Optional[Mapping[str, tuple]] = None, n_iter: int = N_STEPS,
                     rel_tol: Optional[float] = None) -> dict:
    """Run ``names`` over ``n_ranks`` spawned ranks and hold each against world size 1; raise on any miss.

    ``device="cpu"`` runs gloo ranks on the CPU; on the card, ranks beyond
    the number of cards share a card over gloo (:func:`spawn`). Each rank
    runs ``n_iter`` steps at :func:`make_inputs`'s shapes in float32, or on
    ``inputs`` (name -> the global ``(X, carry)`` in :func:`make_inputs`'s
    layout, two utterances a row of ranks), and holds every output against
    the same runner at world size 1 within the case's tolerance on its
    measure, or within ``rel_tol`` on the ``"rel"`` measure (the given
    inputs' magnitudes are not the dry run's), and the all-reduces through
    the bin hook against its pin. The launches summed over the ranks must
    equal the case's ``launches`` on the card (none on the CPU, where the
    wrappers take their plain versions). With ``kernel_tols`` (kernel ->
    the largest relative error against its plain version, 0 for bit for
    bit) each rank also holds every kernel call of its sharded run at its
    own shapes, and every kernel the case launches must have been held.
    Returns rank 0's report with each case's tolerance, and the launches,
    all-reduces and holds summed over the ranks.
    """
    on_card = torch.device(device).type == "cuda"
    measure = None if rel_tol is None else "rel"
    reports = spawn(n_ranks, _rank_cases, (tuple(names), str(device), kernel_tols is not None, inputs, n_iter, measure),
                    device=device, backend=backend)
    report = reports[0]
    misses = []
    for name in names:
        case = CASES[name]
        tol = case.tol if rel_tol is None else rel_tol
        for r in reports:
            got = r["cases"][name]
            pin = 0 if r["shape"][1] == 1 else case.pin * n_iter + case.extra
            if not (got["finite"] and got["max_abs_err"] <= tol and got["shapes"] == got["ref_shapes"]):
                misses.append(f"{name} rank {r['rank']}: error {got['max_abs_err']} > {tol} or not finite "
                              f"or shapes {got['shapes']} != {got['ref_shapes']}")
            if got["bin_sum_calls"] != pin:
                misses.append(f"{name} rank {r['rank']}: {got['bin_sum_calls']} all-reduces, expected {pin}")
        launches = {k: sum(r["cases"][name]["launches"][k] for r in reports) for k in KERNELS}
        expected = {k: n_ranks * n_iter * case.launches.get(k, 0) if on_card else 0 for k in KERNELS}
        if launches != expected:
            misses.append(f"{name}: launches {launches}, expected {expected}")
        held = {}
        for r in reports:
            for kernel, (n_held, worst) in r["cases"][name]["held"].items():
                n_before, worst_before = held.get(kernel, (0, 0.0))
                held[kernel] = (n_before + n_held, max(worst_before, worst))
        if kernel_tols is not None:
            for kernel in case.launches:
                n_held, worst = held.get(kernel, (0, float("nan")))
                if not (n_held and worst <= kernel_tols[kernel]):
                    misses.append(f"{name}: {kernel} held on {n_held} calls, error {worst} > {kernel_tols[kernel]}")
        report["cases"][name].update(tol=tol, launches=launches, held=held)
    if misses:
        raise AssertionError("dry run failed:\n" + "\n".join(misses))
    return report


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_ranks", type=int)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--all", action="store_true", help="every runner of the slice, not only the six layouts")
    args = parser.parse_args()
    report = dryrun_multichip(args.n_ranks, device=args.device, names=tuple(CASES) if args.all else DRYRUN_CASES)
    print(json.dumps(report, default=str))


if __name__ == "__main__":
    main()
