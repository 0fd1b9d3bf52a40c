"""The hand-written CUDA kernels of the IVA, ILRMA, IPA, prox-family and dense-MNMF steps, with their plain versions.

- :func:`weighted_covariance` — ``U[i,n] = mean_t phi[n,(i),t] x_it x_it^H``,
  counterpart of ``ssspy_tpu.ops.pallas_kernels.weighted_covariance_sc``
  (pallas_kernels.py:40-186); kernel ``csrc/weighted_covariance.cu``.
- :func:`ip1_sweep` — the sequential IP1 source sweep, counterpart of
  ``ssspy_tpu.ops.splitc.ip1_sweep_sc`` with ``csolve`` /
  ``gauss_jordan_solve_nopivot`` (splitc.py:168-344); kernel
  ``csrc/ip1_sweep.cu``.
- :func:`iss1_sweep` — the sequential ISS1 source-steering sweep,
  counterpart of ``ssspy_tpu.ops.pallas_kernels.iss1_sweep_pallas`` and
  ``ssspy_tpu.ops.splitc.iss1_sweep_sc`` (pallas_kernels.py:729-808,
  splitc.py:347-398); kernel ``csrc/iss1_sweep.cu``.
- :func:`jacobi_eigh` — batched real symmetric eigh by fixed-sweep
  round-robin Jacobi, counterpart of
  ``ssspy_tpu.ops.pallas_kernels.jacobi_eigh_lanes`` and
  ``ssspy_tpu.ops.jacobi.jacobi_eigh`` (pallas_kernels.py:811-943,
  jacobi.py:25-181); kernel ``csrc/jacobi_eigh.cu``.
- :func:`ipa_congruence` — one round of the IPA congruence sweep,
  ``U[s] <- T U[s] T^H`` for every source and ``G <- T G`` per bin,
  counterpart of ``ssspy_tpu.ops.pallas_kernels.ipa_congruence_lanes``
  (pallas_kernels.py:417-496); kernel ``csrc/ipa_congruence.cu``.
- :func:`gj_inverse` — ``R^-1`` of a batch of small Hermitian positive
  definite systems by pivot-free complex Gauss-Jordan, counterpart of
  ``ssspy_tpu.ops.pallas_kernels.planar_inverse_sc``
  (pallas_kernels.py:201-300); kernel ``csrc/gj_inverse.cu``.
- :func:`inv_sandwich` — ``(R^-1, R^-1 C R^-1)`` of a batch of small
  Hermitian systems by pivot-free complex Gauss-Jordan, counterpart of
  ``ssspy_tpu.ops.pallas_kernels.planar_inv_sandwich_sc``
  (pallas_kernels.py:334-414); kernel ``csrc/inv_sandwich.cu``.
- :func:`model_traces` — the fused dense-MNMF model pass (model, inverse,
  sandwich, traces and the frame sums P and Q), counterpart of
  ``ssspy_tpu.ops.pallas_kernels.planar_model_traces_sc``
  (pallas_kernels.py:499-726); kernel ``csrc/mnmf_model_traces.cu``.
  These three share the elimination of ``csrc/gj_inverse.cuh``, whose plain
  version is :func:`gj_inverse_plain`.

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors, which must be complex64/float32 and
contiguous; anything else raises. ``<wrapper>.launches`` counts kernel
launches (never plain calls). Where a kernel takes a bounded size, the
predicate ``<wrapper>_takes`` says whether it takes a shape, so that a
caller can choose its route by shape before any launch: one named router
per operation does (``iva_steps.covariance``, ``ip1_update`` and
``iss1_update``, ``ipa_steps.congruence_round``, ``prox_steps.symm_eigh``,
``ipsdta_steps.hermitian_inverse``, ``mnmf_steps._inv_sandwich`` and
``_fused``; PERF.md lists the sizes).
"""

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from ..special.flooring import floor
from . import _build

__all__ = [
    "weighted_covariance",
    "weighted_covariance_plain",
    "weighted_covariance_takes",
    "weighted_covariance_geometry",
    "ip1_sweep",
    "ip1_sweep_plain",
    "ip1_sweep_takes",
    "ip1_sweep_variant",
    "gauss_jordan_solve_nopivot",
    "iss1_sweep",
    "iss1_sweep_plain",
    "iss1_sweep_takes",
    "iss1_sweep_resident",
    "iss1_sweep_variant",
    "iss1_sweep_register_warps",
    "round_pairs",
    "partner_table",
    "jacobi_sweeps",
    "jacobi_eigh",
    "jacobi_eigh_plain",
    "jacobi_eigh_takes",
    "ipa_congruence",
    "ipa_congruence_plain",
    "ipa_congruence_takes",
    "gj_inverse",
    "gj_inverse_plain",
    "gj_inverse_takes",
    "gj_inverse_geometry",
    "inv_sandwich",
    "inv_sandwich_takes",
    "inv_sandwich_plain",
    "inv_sandwich_variant",
    "model_traces",
    "model_traces_plain",
    "model_traces_takes",
    "model_traces_geometry",
    "source_of",
]

# limits the kernels take, mirrored from csrc/*.cu
_SMEM_LIMIT = 48 * 1024
_GJ_TINY = 1e-20
_ISS1_MAX_SOURCES = 16
_ISS1_HEADER_BYTES = 16 * 8 + 16 * 3 * 16 * 4  # v and the reduction table
# the ISS1 register variant by template width: frames a thread, most warps a bin
_ISS1_REG_FRAMES = {2: 4, 4: 4, 8: 4, 16: 1}
_ISS1_REG_WARPS = {2: 16, 4: 16, 8: 10, 16: 12}
_ISS1_VARIANTS = {"streamed": 0, "resident": 1, "registers": 2}  # the launch's `variant`
_SMEM_BLOCK_MAX = 232448  # 227 KB of dynamic shared memory per block on sm_90

_VOID, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "weighted_covariance": (
        "weighted_covariance_launch",
        [_VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _INT, _VOID],
    ),
    "ip1_sweep": (
        "ip1_sweep_launch",
        [_VOID, _VOID, _VOID, _INT, _INT, _INT, _FLOAT, _INT, _VOID],
    ),
    "iss1_sweep": (
        "iss1_sweep_launch",
        [_VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _INT, _FLOAT, _INT, _VOID],
    ),
    "jacobi_eigh": (
        "jacobi_eigh_launch",
        [_VOID, _VOID, _VOID, _INT, _INT, _INT, _FLOAT, _INT, _VOID],
    ),
    "ipa_congruence": (
        "ipa_congruence_launch",
        [_VOID, _VOID, _VOID, _VOID, _VOID, _INT, _INT, _INT, _INT, _VOID],
    ),
    "gj_inverse": (
        "gj_inverse_launch",
        [_VOID, _VOID, _INT, _INT, _FLOAT, _INT, _VOID],
    ),
    "inv_sandwich": (
        "inv_sandwich_launch",
        [_VOID, _VOID, _VOID, _VOID, _INT, _INT, _FLOAT, _INT, _INT, _VOID],
    ),
    "model_traces": (
        "model_traces_launch",
        [_VOID] * 8 + [_INT, _INT, _INT, _INT, _INT, _FLOAT, _FLOAT, _INT, _VOID],
    ),
}
# the source file of a kernel, where it is not named after its wrapper
_SOURCES = {"model_traces": "mnmf_model_traces"}


def source_of(name: str) -> str:
    """The ``csrc/<source>.cu`` stem that kernel ``name`` is built from."""
    return _SOURCES.get(name, name)


_entries = {}


def _entry(name: str):
    """``(library, typed C launch function)`` of kernel ``name``, built on first use."""
    entry = _entries.get(name)
    if entry is None:
        lib = _build.load(source_of(name))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entry = _entries[name] = (lib, fn)
    return entry


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(message)


def _check_cuda(name: str, *tensors) -> None:
    device = tensors[0].device
    _require(
        device.type == "cuda" and all(t.device == device for t in tensors),
        f"{name}: expected all CPU tensors (plain version) or all CUDA tensors on one "
        f"device (kernel), got {[str(t.device) for t in tensors]}",
    )


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---- weighted covariance --------------------------------------------------


def weighted_covariance_plain(X: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """``U[i,n] = mean_t varphi[n,(i),t] x_it x_it^H`` by einsum.

    ``X``: complex ``(M, I, T)``; ``varphi``: real ``(N, T)`` or per-bin
    ``(N, I, T)``. Returns complex ``(I, N, M, M)``. The einsum of
    ``_wcov_einsum`` (pallas_kernels.py:143-152) on native complex.
    """
    eq = "nit,pit,qit->inpq" if varphi.dim() == 3 else "nt,pit,qit->inpq"
    return torch.einsum(eq, varphi.to(X.dtype), X, X.conj()) / X.shape[-1]


# The size contract: the (M, N) of the first kernel (one block per bin, one
# thread per entry, a padded chunk of 128 frames of X and varphi in 48 KB).
# The present kernel takes every one of them and no other.
_WCOV_CONTRACT_ENTRIES = 1024 * 8
_WCOV_CONTRACT_ROW = 128 + 1
# the present kernel, mirrored from csrc/weighted_covariance.cu
_WCOV_SOURCES = 8  # sources per work item
_WCOV_PAIRS = 4  # channel pairs per work item: a 2 x 2 tile
_WCOV_TILE_FRAMES = 128  # frames of X and varphi per cp.async buffer
_WCOV_STAGES = 3  # cp.async buffers: two tiles in flight while one is summed
_WCOV_MAX_WARPS = 16  # items of one block at once, a warp each


def weighted_covariance_takes(M: int, N: int) -> bool:
    """Whether the covariance kernel takes ``M`` channels and ``N`` sources: the first kernel's size contract."""
    return (
        M >= 1 and N >= 1 and N * M * (M + 1) // 2 <= _WCOV_CONTRACT_ENTRIES
        and (2 * M + N) * _WCOV_CONTRACT_ROW * 4 <= _SMEM_LIMIT
    )


def weighted_covariance_geometry(M: int, N: int, I: int, T: int) -> dict:
    """The kernel's launch for ``(M, N, I, T)``, as csrc/weighted_covariance.cu sets it up.

    A work item is a 2 x 2 tile of channel pairs (``half = ceil(M / 2)``
    channel pairs a side, ``tiles = half (half + 1) / 2``) and a group of
    up to 8 sources (``items = tiles * ceil(N / 8)``), a warp each, its 32
    lanes on every 32nd frame. One block per bin (``grid``) of ``warps =
    min(items, 16)`` warps takes the items in ``passes``; the frames arrive
    in ``frame_tiles`` tiles of 128. A staged frame holds ``x_row``
    complex64 and ``w_row`` float32 (odd counts of 16-byte words);
    ``smem_bytes``: three buffers of a tile.
    """
    half = -(-M // 2)
    tiles = half * (half + 1) // 2
    groups = -(-N // _WCOV_SOURCES)
    items = tiles * groups
    warps = min(items, _WCOV_MAX_WARPS)
    x_row, w_row = 2 * (half | 1), groups * _WCOV_SOURCES + 4
    return {
        "tiles": tiles,
        "items": items,
        "warps": warps,
        "passes": -(-items // warps),
        "threads": 32 * warps,
        "grid": (I,),
        "frame_tiles": -(-T // _WCOV_TILE_FRAMES),
        "x_row": x_row,
        "w_row": w_row,
        "smem_bytes": _WCOV_STAGES * _WCOV_TILE_FRAMES * (x_row * 8 + w_row * 4),
    }


def _check_weighted_covariance(X: torch.Tensor, varphi: torch.Tensor) -> None:
    name = "weighted_covariance"
    _require(X.dim() == 3, f"{name}: X must be (M, I, T), got {tuple(X.shape)}")
    M, I, T = X.shape
    _require(varphi.dim() in (2, 3), f"{name}: varphi must be (N, T) or (N, I, T)")
    N = varphi.shape[0]
    expected = (N, T) if varphi.dim() == 2 else (N, I, T)
    _require(
        tuple(varphi.shape) == expected,
        f"{name}: varphi shape {tuple(varphi.shape)} does not match X {tuple(X.shape)}",
    )
    _require(X.dtype == torch.complex64, f"{name}: the kernel takes complex64 X, got {X.dtype}")
    _require(
        varphi.dtype == torch.float32, f"{name}: the kernel takes float32 varphi, got {varphi.dtype}"
    )
    _require(X.is_contiguous() and varphi.is_contiguous(), f"{name}: inputs must be contiguous")
    _require(min(M, I, T, N) >= 1, f"{name}: empty input {tuple(X.shape)}, N={N}")
    _require(weighted_covariance_takes(M, N), f"{name}: M={M}, N={N} exceeds what one block of the kernel holds")
    _check_cuda(name, X, varphi)


def weighted_covariance(X: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """Weighted covariance ``(I, N, M, M)``; kernel on CUDA, plain version on CPU.

    ``X``: complex ``(M, I, T)``; ``varphi``: ``(N, T)`` scalar weights
    (IVA) or ``(N, I, T)`` per-bin weights (ILRMA/FDICA/MNMF).
    """
    if _on_cpu(X, varphi):
        return weighted_covariance_plain(X, varphi)
    _check_weighted_covariance(X, varphi)
    M, I, T = X.shape
    N = varphi.shape[0]
    lib, launch = _entry("weighted_covariance")
    U = torch.empty((I, N, M, M), dtype=torch.complex64, device=X.device)
    status = launch(
        X.data_ptr(), varphi.data_ptr(), U.data_ptr(), M, N, I, T,
        int(varphi.dim() == 3), X.device.index, _stream(X.device),
    )
    _build.check(lib, "weighted_covariance", status)
    weighted_covariance.launches += 1
    return U


weighted_covariance.launches = 0


# ---- IP1 sweep --------------------------------------------------------------


def gauss_jordan_solve_nopivot(A: torch.Tensor, b: torch.Tensor, tiny: float = _GJ_TINY) -> torch.Tensor:
    """Pivot-free complex Gauss-Jordan solve of ``A x = b``, batched.

    ``A``: ``(..., n, n)``; ``b``: ``(..., n)``. A pivot with
    ``|p| < tiny`` is floored to magnitude ``tiny`` keeping its phase (0
    becomes ``tiny``), so a singular system gives large-but-finite values
    instead of NaN — the rule of ``splitc.gauss_jordan_solve_nopivot``
    (splitc.py:168-199) applied to the complex pivot. Same elimination,
    same order, as ``csrc/ip1_sweep.cu``.
    """
    return _gauss_jordan(torch.cat([A, b[..., None]], dim=-1), tiny)[..., 0]


def _gauss_jordan(M: torch.Tensor, tiny: float) -> torch.Tensor:
    """Pivot-free Gauss-Jordan on the augmented ``(..., n, n + k)`` system ``M``; returns its last ``k`` columns.

    For ``k = 0 .. n-1``: row ``k`` over its pivot, floored to magnitude
    ``tiny`` keeping its phase, then every other row minus its entry in
    column ``k`` times that row (csrc/gj_inverse.cuh).
    """
    n = M.shape[-2]
    for k in range(n):
        pivot = M[..., k, k : k + 1]
        mag = pivot.abs()
        floored = torch.where(mag > 0, pivot / mag * tiny, torch.full_like(pivot, tiny))
        pivot = torch.where(mag < tiny, floored, pivot)
        pivot_row = M[..., k, :] / pivot
        M = M - M[..., :, k, None] * pivot_row[..., None, :]
        M[..., k, :] = pivot_row
    return M[..., n:]


def ip1_sweep_plain(
    W: torch.Tensor, U: torch.Tensor, eps: float = 1e-10, solve_impl: str = "lu", flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """Sequential IP1 sweep in plain PyTorch; returns the new ``W``.

    ``W``: ``(I, N, M)``; ``U``: ``(I, N, M, M)``, Hermitian per source.
    Each source solves ``(W U_n) w = e_n``, normalises by
    ``sqrt(w^H U_n w)`` and keeps its row where ``w^H U_n w <= 0`` or NaN
    (splitc.py:281-344). ``solve_impl``: ``"lu"`` (``torch.linalg.solve_ex``,
    which returns non-finite values on a singular system for the freeze to
    absorb where ``torch.linalg.solve`` would raise) or ``"gjnp"``
    (:func:`gauss_jordan_solve_nopivot`, the kernel's exact elimination).
    ``flooring_fn`` replaces ``max(., eps)`` on the norm, as
    ``update_by_ip1`` floors it (ssspy_tpu/bss/_update_spatial_model.py:75).
    """
    if solve_impl not in ("lu", "gjnp"):
        raise ValueError(f"unknown solve_impl {solve_impl!r}; expected 'lu' or 'gjnp'")
    n_bins, n_sources, n_channels = W.shape
    W = W.clone()
    eye = torch.eye(n_sources, n_channels, dtype=W.dtype, device=W.device)
    for n in range(n_sources):
        U_n = U[:, n]
        A = W @ U_n
        b = eye[n].expand(n_bins, n_channels)
        if solve_impl == "lu":
            w = torch.linalg.solve_ex(A, b)[0]
        else:
            w = gauss_jordan_solve_nopivot(A, b)
        z = (U_n @ w[..., None])[..., 0]
        wUw = (w.real * z.real + w.imag * z.imag).sum(-1)
        denom = floor(torch.sqrt(torch.clamp(wUw, min=0.0)), eps, flooring_fn)
        valid = (wUw > 0.0)[:, None]
        W[:, n] = torch.where(valid, w.conj() / denom[:, None], W[:, n])
    return W


_IP1_WARP_MAX_M = 8  # the warp variant's largest M, mirrored from csrc/ip1_sweep.cu


def ip1_sweep_takes(M: int) -> bool:
    """Whether the sweep kernel takes ``N = M`` sources and channels: ``1 <= M <= 17``.

    The size contract of the first kernel, which kept a bin's ``U``, ``W``
    and ``[A | e_n]`` in 48 KB of shared memory; the block variant still does.
    """
    L = M + 1
    return M >= 1 and (M * M * M + M * M + M * L + L + 2 * M) * 8 <= _SMEM_LIMIT


def ip1_sweep_variant(M: int) -> str:
    """The kernel variant that runs ``N = M``, as csrc/ip1_sweep.cu chooses it.

    ``"warp"`` (``M <= 8``): a group of lanes of one warp per bin, its rows
    in registers, no block barrier; ``"block"`` (``9 <= M <= 17``): one block
    per bin, the system in shared memory.
    """
    if not ip1_sweep_takes(M):
        raise ValueError(f"ip1_sweep: the kernel takes 1 <= M <= 17, got M={M}")
    return "warp" if M <= _IP1_WARP_MAX_M else "block"


def _check_ip1_sweep(W: torch.Tensor, U: torch.Tensor) -> None:
    name = "ip1_sweep"
    _require(W.dim() == 3, f"{name}: W must be (I, N, M), got {tuple(W.shape)}")
    I, N, M = W.shape
    _require(N == M and N >= 1, f"{name}: W must be square per bin, got {tuple(W.shape)}")
    _require(
        tuple(U.shape) == (I, N, M, M),
        f"{name}: U shape {tuple(U.shape)} does not match W {tuple(W.shape)}",
    )
    _require(
        W.dtype == torch.complex64 and U.dtype == torch.complex64,
        f"{name}: the kernel takes complex64, got {W.dtype}, {U.dtype}",
    )
    _require(W.is_contiguous() and U.is_contiguous(), f"{name}: inputs must be contiguous")
    _require(I >= 1, f"{name}: no bins")
    _require(
        ip1_sweep_takes(M),
        f"{name}: N=M={M} exceeds what one block of the kernel holds in shared memory",
    )
    _check_cuda(name, W, U)


def ip1_sweep(W: torch.Tensor, U: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """IP1 sweep; kernel on CUDA, :func:`ip1_sweep_plain` (``"lu"``) on CPU.

    The kernel takes complex64 and ``N = M <= 17``, in the variant
    :func:`ip1_sweep_variant` names.
    """
    if _on_cpu(W, U):
        return ip1_sweep_plain(W, U, eps)
    _check_ip1_sweep(W, U)
    I, N, M = W.shape
    lib, launch = _entry("ip1_sweep")
    W_out = torch.empty_like(W)
    status = launch(
        W.data_ptr(), U.data_ptr(), W_out.data_ptr(), I, N, M, float(eps),
        W.device.index, _stream(W.device),
    )
    _build.check(lib, "ip1_sweep", status)
    ip1_sweep.launches += 1
    return W_out


ip1_sweep.launches = 0


# ---- ISS1 sweep -------------------------------------------------------------


def iss1_sweep_plain(
    Y: torch.Tensor, varphi: torch.Tensor, eps: float = 1e-10, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """Sequential ISS1 sweep in plain PyTorch; returns the new ``Y``.

    ``Y``: complex ``(N, I, T)``; ``varphi``: real ``(N, T)`` (IVA) or
    per-bin ``(N, I, T)`` (ILRMA). For each source n in order,
    ``v[m] = mean_t phi_m y_m conj(y_n) / denom[m]`` with
    ``denom[m] = max(mean_t phi_m |y_n|^2, eps)``, ``v[n] = 1 - 1/sqrt(denom[n])``,
    then ``Y -= v y_n`` with the ``y_n`` of before the update; later sources
    see the updated ``Y``. The loop of splitc.py:376-398 on native complex.
    ``flooring_fn`` replaces ``max(., eps)`` on ``denom``, as
    ``update_by_iss1`` floors it (ssspy_tpu/bss/_update_spatial_model.py:181).
    """
    if varphi.dim() == 2:
        varphi = varphi[:, None, :]
    for n in range(Y.shape[0]):
        Y_n = Y[n]  # (I, T)
        num = torch.mean(varphi * (Y * Y_n.conj()), dim=-1)  # (N, I)
        denom = floor(torch.mean(varphi * (Y_n.real**2 + Y_n.imag**2), dim=-1), eps, flooring_fn)
        v = num / denom
        v[n] = 1 - 1 / torch.sqrt(denom[n])
        Y = Y - v[:, :, None] * Y_n
    return Y


def iss1_sweep_takes(n_sources: int) -> bool:
    """Whether the sweep kernel takes ``N`` sources: ``1 <= N <= 16``, any number of frames."""
    return 1 <= n_sources <= _ISS1_MAX_SOURCES


def iss1_sweep_resident(n_sources: int, n_frames: int, per_bin: bool) -> bool:
    """Whether a bin fits one block's shared memory (the resident variant; else the streamed one).

    The resident variant holds the bin's Y (``N * T`` complex64) and, for
    per-bin weights, its weights (``N * T`` float32) in one block's
    dynamic shared memory; the streamed variant keeps Y in device memory
    and takes any ``T`` (csrc/iss1_sweep.cu). :func:`iss1_sweep_variant`
    asks it for the bins too long for the register variant.
    """
    per_frame = 8 + (4 if per_bin else 0)
    return _ISS1_HEADER_BYTES + n_sources * n_frames * per_frame <= _SMEM_BLOCK_MAX


def _iss1_width(n_sources: int) -> int:
    """The kernel's template on the sources: 2, 4, 8 or 16."""
    return 2 if n_sources <= 2 else 4 if n_sources <= 4 else 8 if n_sources <= 8 else 16


def iss1_sweep_register_warps(n_sources: int, n_frames: int) -> int:
    """Warps a bin of the register variant: ``ceil(T / (32 F))``, ``F`` frames a thread."""
    return -(-n_frames // (32 * _ISS1_REG_FRAMES[_iss1_width(n_sources)]))


def iss1_sweep_variant(n_sources: int, n_frames: int, per_bin: bool) -> str:
    """The kernel variant that runs a bin of ``N`` sources and ``T`` frames, as the wrapper passes it.

    ``"registers"`` while :func:`iss1_sweep_register_warps` stays within the
    template's most warps (each thread keeps its ``F`` frames of Y and of
    the weights in registers; ``T <= 1,280`` at ``N = 8``), else
    ``"resident"`` while :func:`iss1_sweep_resident`, else ``"streamed"``.
    """
    if iss1_sweep_register_warps(n_sources, n_frames) <= _ISS1_REG_WARPS[_iss1_width(n_sources)]:
        return "registers"
    return "resident" if iss1_sweep_resident(n_sources, n_frames, per_bin) else "streamed"


def _check_iss1_sweep(Y: torch.Tensor, varphi: torch.Tensor) -> None:
    name = "iss1_sweep"
    _require(Y.dim() == 3, f"{name}: Y must be (N, I, T), got {tuple(Y.shape)}")
    N, I, T = Y.shape
    _require(varphi.dim() in (2, 3), f"{name}: varphi must be (N, T) or (N, I, T)")
    expected = (N, T) if varphi.dim() == 2 else (N, I, T)
    _require(
        tuple(varphi.shape) == expected,
        f"{name}: varphi shape {tuple(varphi.shape)} does not match Y {tuple(Y.shape)}",
    )
    _require(Y.dtype == torch.complex64, f"{name}: the kernel takes complex64 Y, got {Y.dtype}")
    _require(
        varphi.dtype == torch.float32, f"{name}: the kernel takes float32 varphi, got {varphi.dtype}"
    )
    _require(Y.is_contiguous() and varphi.is_contiguous(), f"{name}: inputs must be contiguous")
    _require(min(N, I, T) >= 1, f"{name}: empty input {tuple(Y.shape)}")
    _require(iss1_sweep_takes(N), f"{name}: N={N} sources exceeds the kernel's {_ISS1_MAX_SOURCES}")
    _check_cuda(name, Y, varphi)


def iss1_sweep(Y: torch.Tensor, varphi: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """ISS1 sweep; kernel on CUDA, :func:`iss1_sweep_plain` on CPU.

    ``Y``: complex ``(N, I, T)``; ``varphi``: ``(N, T)`` (IVA) or
    ``(N, I, T)`` (ILRMA). Returns the new ``Y``. The kernel takes
    complex64 and ``N <= 16``, in the variant :func:`iss1_sweep_variant`
    names.
    """
    if _on_cpu(Y, varphi):
        return iss1_sweep_plain(Y, varphi, eps)
    _check_iss1_sweep(Y, varphi)
    N, I, T = Y.shape
    per_bin = varphi.dim() == 3
    lib, launch = _entry("iss1_sweep")
    Y_out = torch.empty_like(Y)
    status = launch(
        Y.data_ptr(), varphi.data_ptr(), Y_out.data_ptr(), N, I, T, int(per_bin),
        _ISS1_VARIANTS[iss1_sweep_variant(N, T, per_bin)], float(eps), Y.device.index, _stream(Y.device),
    )
    _build.check(lib, "iss1_sweep", status)
    iss1_sweep.launches += 1
    return Y_out


iss1_sweep.launches = 0


# ---- batched symmetric eigh (round-robin Jacobi) ------------------------------

_JACOBI_MAX_N = 32  # n lanes of one warp per matrix, mirrored from csrc/jacobi_eigh.cu


@functools.lru_cache(maxsize=None)
def round_pairs(n: int) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Round-robin tournament pairings of ``n`` indices: rounds of disjoint ``(p, q)``, ``p < q``.

    One cycle of rounds covers every off-diagonal position once; odd ``n``
    adds a virtual player ``n``, whose partner sits the round out (the
    bye). The schedule of ``ssspy_tpu.ops.jacobi._round_pairs``
    (jacobi.py:25-44), which the Pallas kernel and the XLA form share.
    """
    players = list(range(n)) + ([n] if n % 2 == 1 else [])
    m = len(players)
    rounds = []
    arr = players[:]
    for _ in range(m - 1):
        pairs = []
        for k in range(m // 2):
            p, q = arr[k], arr[m - 1 - k]
            if p < n and q < n:
                pairs.append((min(p, q), max(p, q)))
        rounds.append(tuple(pairs))
        arr = [arr[0]] + [arr[-1]] + arr[1:-1]
    return tuple(rounds)


_partner_tables = {}


def partner_table(n: int, device=None) -> torch.Tensor:
    """``(n_rounds, n)`` int32 partner of each index per round of :func:`round_pairs`; cached per ``(n, device)``.

    An index without a pair (the bye of odd ``n``) is its own partner. The
    plain version and the kernel both read this table, so they rotate in
    the same order.
    """
    device = torch.device("cpu") if device is None else torch.device(device)
    key = (n, device)
    table = _partner_tables.get(key)
    if table is None:
        rows = []
        for pairs in round_pairs(n):
            partner = list(range(n))
            for p, q in pairs:
                partner[p], partner[q] = q, p
            rows.append(partner)
        table = _partner_tables[key] = torch.tensor(rows, dtype=torch.int32, device=device)
    return table


def jacobi_sweeps(n: int) -> int:
    """Default sweep count: 6 through ``n = 32``, 8 above (jacobi.py:107-109)."""
    return 6 if n <= 32 else 8


def _jacobi_rotation(A, partner, index, tiny):
    """Per-index ``(c, s')`` of one round: ``row_i <- c row_i + s' row_partner(i)``.

    For the pair ``(p, q)``: ``tau = (a_qq - a_pp) / (2 a_pq)`` with the
    symmetrised ``a_pq``, ``t = sgn(tau) / (|tau| + sqrt(1 + tau^2))``
    (``sgn(0) = +1``), ``t = 0`` where ``|a_pq| < tiny``, ``c = 1/sqrt(1+t^2)``,
    ``s = t c``; index ``p`` takes ``-s`` and ``q`` takes ``+s``
    (pallas_kernels.py:848-867). The bye keeps ``c = 1``, ``s' = 0``.
    """
    p_idx, q_idx = torch.minimum(index, partner), torch.maximum(index, partner)
    diag = A.diagonal(dim1=-2, dim2=-1)
    app, aqq = diag[:, p_idx], diag[:, q_idx]
    apq = (A[:, p_idx, q_idx] + A[:, q_idx, p_idx]) * 0.5
    small = (apq.abs() < tiny) | (p_idx == q_idx)
    tau = (aqq - app) / (2 * torch.where(small, torch.full_like(apq, tiny), apq))
    sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
    t = sgn / (tau.abs() + torch.sqrt(1 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1 + t * t)
    s = t * c
    return c, torch.where(index == p_idx, -s, s)


def jacobi_eigh_plain(
    A: torch.Tensor, sweeps: Optional[int] = None, tiny: float = 1e-30
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of real symmetric ``(B, n, n)`` matrices by round-robin Jacobi.

    Returns ``(lamb (B, n) ascending, V (B, n, n))`` with orthonormal
    columns, ``A V = V diag(lamb)``. Each of ``sweeps x rounds(n)`` rounds
    applies its disjoint rotations as two elementwise passes against the
    partner-permuted copy (rows, then columns), and V takes the column
    pass: the lanes form of the Pallas kernel (pallas_kernels.py:842-891),
    the arithmetic of ``csrc/jacobi_eigh.cu``. A is read as given (the
    symmetrised off-diagonal pair drives each rotation). The sort is
    stable; NaN sorts last.
    """
    n = A.shape[-1]
    sweeps = jacobi_sweeps(n) if sweeps is None else sweeps
    table = partner_table(n, A.device).long()
    index = torch.arange(n, device=A.device)
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for partner in table:
            c, s = _jacobi_rotation(A, partner, index, tiny)
            A = c[:, :, None] * A + s[:, :, None] * A[:, partner, :]
            A = c[:, None, :] * A + s[:, None, :] * A[:, :, partner]
            V = c[:, None, :] * V + s[:, None, :] * V[:, :, partner]
    lamb, order = torch.sort(A.diagonal(dim1=-2, dim2=-1), dim=-1, stable=True)
    return lamb, torch.gather(V, -1, order[:, None, :].expand(V.shape))


def jacobi_eigh_takes(n: int) -> bool:
    """Whether the Jacobi kernel takes ``n x n`` matrices: ``2 <= n <= 32``."""
    return 2 <= n <= _JACOBI_MAX_N


def _check_jacobi_eigh(A: torch.Tensor) -> None:
    name = "jacobi_eigh"
    _require(A.dim() == 3, f"{name}: A must be (B, n, n), got {tuple(A.shape)}")
    B, n, n2 = A.shape
    _require(n == n2, f"{name}: A must be square, got {tuple(A.shape)}")
    _require(
        jacobi_eigh_takes(n), f"{name}: the kernel takes 2 <= n <= {_JACOBI_MAX_N}, got n={n}"
    )
    _require(A.dtype == torch.float32, f"{name}: the kernel takes float32 A, got {A.dtype}")
    _require(A.is_contiguous(), f"{name}: A must be contiguous")
    _require(B >= 1, f"{name}: empty batch")
    _check_cuda(name, A)


def jacobi_eigh(
    A: torch.Tensor, sweeps: Optional[int] = None, tiny: float = 1e-30
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched symmetric eigh ``(B, n, n) -> (lamb (B, n), V (B, n, n))``; kernel on CUDA, plain on CPU.

    Ascending eigenvalues, orthonormal columns; the iteration of
    :func:`jacobi_eigh_plain`, ``sweeps`` defaulting to
    :func:`jacobi_sweeps`. The kernel takes float32, ``2 <= n <= 32``.
    """
    if _on_cpu(A):
        return jacobi_eigh_plain(A, sweeps, tiny)
    _check_jacobi_eigh(A)
    B, n, _ = A.shape
    sweeps = jacobi_sweeps(n) if sweeps is None else int(sweeps)
    lib, launch = _entry("jacobi_eigh")
    lamb = torch.empty((B, n), dtype=A.dtype, device=A.device)
    V = torch.empty_like(A)
    status = launch(
        A.data_ptr(), lamb.data_ptr(), V.data_ptr(), B, n, sweeps, float(tiny), A.device.index, _stream(A.device)
    )
    _build.check(lib, "jacobi_eigh", status)
    jacobi_eigh.launches += 1
    return lamb, V


jacobi_eigh.launches = 0


# ---- IPA congruence round -----------------------------------------------------

_IPA_MAX_N = 16  # sources and channels per bin, mirrored from csrc/ipa_congruence.cu


def ipa_congruence_plain(
    T: torch.Tensor, U: torch.Tensor, G: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T U[s] T^H for every s, T G)`` per bin, by einsum on native complex.

    ``T``, ``G``: ``(I, N, N)``; ``U``: ``(I, S, N, N)``. The products of
    the XLA congruence engine (splitc.py:2101-2120) in their order:
    ``T U[s]`` first, then its product with ``T^H``. Nothing is hermitized.
    """
    TU = torch.einsum("inm,ismp->isnp", T, U)
    return torch.einsum("isnp,iqp->isnq", TU, T.conj()), torch.einsum("inm,imp->inp", T, G)


def ipa_congruence_takes(N: int, S: int) -> bool:
    """Whether the congruence kernel takes ``N`` channels and ``S`` sources per bin: ``1 <= N, S <= 16``."""
    return 1 <= N <= _IPA_MAX_N and 1 <= S <= _IPA_MAX_N


def _check_ipa_congruence(T: torch.Tensor, U: torch.Tensor, G: torch.Tensor) -> None:
    name = "ipa_congruence"
    _require(T.dim() == 3 and T.shape[-1] == T.shape[-2], f"{name}: T must be (I, N, N), got {tuple(T.shape)}")
    I, N, _ = T.shape
    _require(U.dim() == 4, f"{name}: U must be (I, S, N, N), got {tuple(U.shape)}")
    S = U.shape[1]
    _require(
        tuple(U.shape) == (I, S, N, N) and tuple(G.shape) == (I, N, N),
        f"{name}: U {tuple(U.shape)} and G {tuple(G.shape)} do not match T {tuple(T.shape)}",
    )
    _require(
        T.dtype == U.dtype == G.dtype == torch.complex64,
        f"{name}: the kernel takes complex64, got {T.dtype}, {U.dtype}, {G.dtype}",
    )
    _require(
        T.is_contiguous() and U.is_contiguous() and G.is_contiguous(), f"{name}: inputs must be contiguous"
    )
    _require(I >= 1, f"{name}: no bins")
    _require(
        ipa_congruence_takes(N, S),
        f"{name}: the kernel takes N, S <= {_IPA_MAX_N}, got N={N}, S={S}",
    )
    _require(I * (S + 1) < 2**31, f"{name}: {I} bins of {S} sources")
    _check_cuda(name, T, U, G)


def ipa_congruence(
    T: torch.Tensor, U: torch.Tensor, G: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One IPA congruence round ``(U', G')``; kernel on CUDA, :func:`ipa_congruence_plain` on CPU.

    ``U'[i, s] = T[i] U[i, s] T[i]^H`` and ``G'[i] = T[i] G[i]`` for a
    general ``T``: ``T``, ``G`` complex ``(I, N, N)``, ``U`` complex
    ``(I, S, N, N)``. The result is not hermitized. The kernel takes
    complex64 and ``N, S <= 16``.
    """
    if _on_cpu(T, U, G):
        return ipa_congruence_plain(T, U, G)
    _check_ipa_congruence(T, U, G)
    I, S, N, _ = U.shape
    lib, launch = _entry("ipa_congruence")
    U_out, G_out = torch.empty_like(U), torch.empty_like(G)
    status = launch(
        T.data_ptr(), U.data_ptr(), G.data_ptr(), U_out.data_ptr(), G_out.data_ptr(), I, S, N,
        T.device.index, _stream(T.device),
    )
    _build.check(lib, "ipa_congruence", status)
    ipa_congruence.launches += 1
    return U_out, G_out


ipa_congruence.launches = 0


# ---- batched Hermitian inverse (IPSDTA's model) ------------------------------------

_GJ_MAX_M = 32  # a group of m threads in one warp, mirrored from csrc/gj_inverse.cuh
_GJ_SYSTEM_MAX_M = 8  # one thread per system, [R | I] in registers (csrc/gj_inverse.cu)
_SANDWICH_MAX_M = 16  # K4 and K5 keep each thread's row of their products in registers
_SANDWICH_COLUMNS_MAX_M = 8  # the columns variant's largest m, mirrored from csrc/inv_sandwich.cu
_SANDWICH_VARIANTS = {"rows": 0, "columns": 1}  # the launch's `variant`


def gj_inverse_plain(R: torch.Tensor, tiny: float = _GJ_TINY) -> torch.Tensor:
    """Inverse of ``(..., m, m)`` by pivot-free Gauss-Jordan on ``[R | I]``, the floor of :func:`gauss_jordan_solve_nopivot`.

    The complex elimination of ``csrc/gj_inverse.cuh``, step by step; the
    JAX package runs the same elimination on the real embedding
    (``splitc._cinv``, splitc.py:3143-3147, and the Pallas kernel of
    ``planar_inverse_sc``).
    """
    eye = torch.eye(R.shape[-1], dtype=R.dtype, device=R.device).expand(R.shape)
    return _gauss_jordan(torch.cat([R, eye], dim=-1), tiny)


def gj_inverse_takes(m: int) -> bool:
    """Whether the inverse kernel takes ``m x m`` systems: ``1 <= m <= 32``."""
    return 1 <= m <= _GJ_MAX_M


def gj_inverse_geometry(B: int, m: int) -> dict:
    """The launch for ``B`` systems of ``m x m``, as csrc/gj_inverse.cu chooses it.

    ``instance``: ``"system"`` (``1 <= m <= 8``: one thread per system, a
    template on m, 128 systems a block or 64 from m = 7 on, each staged at
    an odd stride, ``m^2`` or ``m^2 + 1``) or ``"rows"`` (``9 <= m <= 32``:
    a group of m threads per system, ``floor(32 / m)`` groups a warp, four
    warps a block or two above m = 16, each row of ``[R | I]`` padded to
    ``2m + 1``).
    """
    if not gj_inverse_takes(m):
        raise ValueError(f"gj_inverse: the kernel takes 1 <= m <= {_GJ_MAX_M}, got m={m}")
    if m <= _GJ_SYSTEM_MAX_M:
        systems = 128 if m <= 6 else 64
        threads, smem = systems, systems * (m * m | 1) * 8
        instance = "system"
    else:
        warps = 2 if m > 16 else 4
        systems, threads = warps * (32 // m), warps * 32
        smem = systems * m * (2 * m + 1) * 8
        instance = "rows"
    return {
        "instance": instance,
        "systems_per_block": systems,
        "threads": threads,
        "blocks": -(-B // systems),
        "smem_bytes": smem,
    }


def _check_gj_inverse(R: torch.Tensor) -> None:
    name = "gj_inverse"
    _require(
        R.dim() >= 3 and R.shape[-1] == R.shape[-2], f"{name}: R must be (..., m, m), got {tuple(R.shape)}"
    )
    _require(R.dtype == torch.complex64, f"{name}: the kernel takes complex64, got {R.dtype}")
    _require(R.is_contiguous(), f"{name}: R must be contiguous")
    m = R.shape[-1]
    _require(gj_inverse_takes(m), f"{name}: the kernel takes 1 <= m <= {_GJ_MAX_M}, got m={m}")
    B = R.numel() // (m * m)
    _require(1 <= B < 2**31, f"{name}: batch of {B} systems")
    _check_cuda(name, R)


def gj_inverse(R: torch.Tensor) -> torch.Tensor:
    """``R^-1`` of Hermitian positive definite ``(..., m, m)``; kernel on CUDA, :func:`gj_inverse_plain` on CPU.

    The kernel takes complex64 and ``1 <= m <= 32``; the batch axes are
    flattened. A pivot under ``1e-20`` in magnitude is floored to ``1e-20``
    keeping its phase, so a zero or singular system gives large, finite
    values.
    """
    if _on_cpu(R):
        return gj_inverse_plain(R)
    _check_gj_inverse(R)
    m = R.shape[-1]
    lib, launch = _entry("gj_inverse")
    Rinv = torch.empty_like(R)
    status = launch(
        R.data_ptr(), Rinv.data_ptr(), R.numel() // (m * m), m, _GJ_TINY, R.device.index, _stream(R.device)
    )
    _build.check(lib, "gj_inverse", status)
    gj_inverse.launches += 1
    return Rinv


gj_inverse.launches = 0


# ---- inverse sandwich (dense MNMF, unfused route) -------------------------------


def inv_sandwich_plain(
    R: torch.Tensor, C: torch.Tensor, tiny: float = _GJ_TINY
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R^-1, (R^-1 C) R^-1)`` of ``(..., m, m)`` pairs: :func:`gj_inverse_plain` and two products.

    The ``"gj"`` branch of ``planar_inv_sandwich_sc`` (pallas_kernels.py:369-375)
    on native complex.
    """
    Rinv = gj_inverse_plain(R, tiny)
    return Rinv, (Rinv @ C) @ Rinv


def inv_sandwich_takes(m: int) -> bool:
    """Whether the inverse-sandwich kernel takes ``m x m`` systems: ``1 <= m <= 16``."""
    return 1 <= m <= _SANDWICH_MAX_M


def inv_sandwich_variant(m: int) -> str:
    """The kernel variant that runs ``m x m`` systems, as the wrapper passes it.

    ``"columns"`` (``m <= 8``): a group of lanes per system, lane c holding
    column c of the live ``[R | I]`` and of C in registers, tiles of
    systems staged by ``cp.async`` in two stages a warp; ``"rows"``
    (``9 <= m <= 16``): a group of m threads per system, ``[R | I]`` and C
    in shared memory (the first design).
    """
    if not inv_sandwich_takes(m):
        raise ValueError(f"inv_sandwich: the kernel takes 1 <= m <= {_SANDWICH_MAX_M}, got m={m}")
    return "columns" if m <= _SANDWICH_COLUMNS_MAX_M else "rows"


def _check_inv_sandwich(R: torch.Tensor, C: torch.Tensor) -> None:
    name = "inv_sandwich"
    _require(
        R.dim() >= 3 and R.shape[-1] == R.shape[-2], f"{name}: R must be (..., m, m), got {tuple(R.shape)}"
    )
    _require(R.shape == C.shape, f"{name}: C {tuple(C.shape)} does not match R {tuple(R.shape)}")
    _require(
        R.dtype == C.dtype == torch.complex64, f"{name}: the kernel takes complex64, got {R.dtype}, {C.dtype}"
    )
    _require(R.is_contiguous() and C.is_contiguous(), f"{name}: inputs must be contiguous")
    m = R.shape[-1]
    _require(inv_sandwich_takes(m), f"{name}: the kernel takes m <= {_SANDWICH_MAX_M}, got m={m}")
    B = R.numel() // (m * m)
    _require(1 <= B < 2**31, f"{name}: batch of {B} systems")
    _check_cuda(name, R, C)


def inv_sandwich(
    R: torch.Tensor, C: torch.Tensor, tiny: float = _GJ_TINY
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R^-1, R^-1 C R^-1)`` for Hermitian ``(..., m, m)`` pairs; kernel on CUDA, :func:`inv_sandwich_plain` on CPU.

    The kernel takes complex64 and ``m <= 16``, in the variant
    :func:`inv_sandwich_variant` names; the batch axes are flattened.
    """
    if _on_cpu(R, C):
        return inv_sandwich_plain(R, C, tiny)
    _check_inv_sandwich(R, C)
    m = R.shape[-1]
    lib, launch = _entry("inv_sandwich")
    Rinv, S = torch.empty_like(R), torch.empty_like(R)
    status = launch(
        R.data_ptr(), C.data_ptr(), Rinv.data_ptr(), S.data_ptr(), R.numel() // (m * m), m, float(tiny),
        _SANDWICH_VARIANTS[inv_sandwich_variant(m)], R.device.index, _stream(R.device),
    )
    _build.check(lib, "inv_sandwich", status)
    inv_sandwich.launches += 1
    return Rinv, S


inv_sandwich.launches = 0


# ---- fused dense-MNMF model pass --------------------------------------------------------

_MT_WARPS = 8  # warps per block, mirrored from csrc/mnmf_model_traces.cu
# blocks the fused pass aims for: a bin's frames are split into chunks until
# about this many (I, S) blocks cover the card, some eight waves of the 264
# that two blocks per SM on 132 SMs run at once, so the last wave's tail is short
_MT_TARGET_BLOCKS = 2048
MODEL_TRACES_OUTPUTS = ("all", "traces", "sums")


def _model_traces_outputs(outputs: str) -> Tuple[bool, bool]:
    if outputs not in MODEL_TRACES_OUTPUTS:
        raise ValueError(f"unknown outputs {outputs!r}; expected one of {MODEL_TRACES_OUTPUTS}")
    return outputs != "sums", outputs != "traces"


def model_traces_plain(
    Lamb: torch.Tensor,
    H: torch.Tensor,
    XX: torch.Tensor,
    eps: float = 1e-10,
    tiny: float = _GJ_TINY,
    outputs: str = "all",
) -> Tuple[torch.Tensor, ...]:
    """``(t1, t2, P, Q)`` of the dense-MNMF model pass, composed from tensor operations.

    ``Lamb``: real ``(N, I, T)``; ``H``: complex ``(N, I, m, m)``; ``XX``:
    complex ``(I, T, m, m)``. With ``R = herm(sum_n Lamb_n herm(H_n)) +
    eps I`` and ``M = R^-1 XX R^-1`` per (bin, frame): ``t1 = Re tr(M H_n)``
    and ``t2 = Re tr(R^-1 H_n)``, real ``(N, I, T)``; ``P = sum_t Lamb R^-1``
    and ``Q = sum_t Lamb M``, complex ``(N, I, m, m)``. The ``"gj"`` branch
    of ``planar_model_traces_sc`` (pallas_kernels.py:651-672) with ``H``
    hermitized first, as the kernels of both packages do (:676-678), and the
    inverse of :func:`gj_inverse_plain`. ``outputs="traces"`` returns
    ``(t1, t2)`` alone, ``"sums"`` ``(P, Q)`` alone.
    """
    traces, sums = _model_traces_outputs(outputs)
    Hh = (H + H.mH) / 2
    Lc = Lamb.to(H.dtype)
    R = torch.einsum("nit,nipq->itpq", Lc, Hh)
    R = (R + R.mH) / 2 + eps * torch.eye(R.shape[-1], dtype=R.dtype, device=R.device)
    Rinv = gj_inverse_plain(R, tiny)
    M = (Rinv @ XX) @ Rinv
    out = ()
    if traces:
        out += (torch.einsum("itab,niba->nit", M, Hh).real, torch.einsum("itab,niba->nit", Rinv, Hh).real)
    if sums:
        out += (torch.einsum("nit,itpq->nipq", Lc, Rinv), torch.einsum("nit,itpq->nipq", Lc, M))
    return out


def model_traces_smem_bytes(n_sources: int, m: int, stages: int) -> int:
    """Shared memory one block of the kernel takes (csrc/mnmf_model_traces.cu:model_traces_smem_bytes).

    Per source the hermitized ``H`` (``m`` rows of ``ld = m + (m >= 8)``
    entries, plus one) and ``P`` and ``Q`` (``2 m^2``); per frame of a tile
    of ``8 floor(32 / m)`` the pivot row and then ``R^-1`` (``m ld + 1``);
    per buffer (``stages``) the tile's ``XX`` (``m^2 + 1`` per frame) and
    ``Lamb`` (``N`` float32 per frame). Complex64 entries of 8 bytes.
    """
    frames = _MT_WARPS * (32 // m)
    ld = m + (1 if m >= 8 else 0)
    complex_entries = n_sources * (m * ld + 1 + 2 * m * m) + frames * (m * ld + 1) + stages * frames * (m * m + 1)
    return complex_entries * 8 + stages * n_sources * frames * 4


def model_traces_geometry(n_sources: int, n_bins: int, n_frames: int, m: int) -> dict:
    """The kernel's launch for ``(N, I, T, m)``, as csrc/mnmf_model_traces.cu sets it up.

    ``frames_per_tile``: ``8 floor(32 / m)``; ``chunk``: the frames of one
    block, whole tiles, so that about 2,048 ``(I, S)`` blocks cover the
    card; ``chunks``: ``S = ceil(T / chunk)``; ``stages``: 2 (the next
    tile's ``XX`` and ``Lamb`` load while the current one computes) where
    two buffers fit one block's 227 KB, else 1; ``smem_bytes`` at that
    count; ``workspace``: the shape of the partial ``P`` and ``Q``.
    """
    frames = _MT_WARPS * (32 // m)
    per_bin = -(-_MT_TARGET_BLOCKS // n_bins)
    chunk = frames * -(-n_frames // (per_bin * frames))
    chunks = -(-n_frames // chunk)
    stages = 2 if model_traces_smem_bytes(n_sources, m, 2) <= _SMEM_BLOCK_MAX else 1
    return {
        "frames_per_tile": frames,
        "chunk": chunk,
        "chunks": chunks,
        "stages": stages,
        "smem_bytes": model_traces_smem_bytes(n_sources, m, stages),
        "workspace": (2, n_sources, n_bins, chunks, m, m),
    }


def _model_traces_contract_bytes(n_sources: int, m: int) -> int:
    """The shared memory of one block of the first (one-block-per-bin) kernel: the size contract K5 keeps.

    ``N (3 m^2 + 1)`` and ``8 floor(32 / m) m (3 m + 1)`` complex64 and
    ``4 N 8 floor(32 / m)`` bytes of ``Lamb``. Every ``(N, m)`` under 227 KB
    by it also fits the present kernel's single-buffered layout
    (:func:`model_traces_smem_bytes` with one stage), which is never larger
    (tests/test_torch_kernels.py).
    """
    frames = _MT_WARPS * (32 // m)
    return (n_sources * (3 * m * m + 1) + frames * m * (3 * m + 1)) * 8 + 4 * n_sources * frames


def model_traces_takes(n_sources: int, m: int) -> bool:
    """Whether the fused kernel takes ``n_sources`` models of ``m x m``: ``m <= 16`` and one block's shared memory."""
    return 1 <= m <= _SANDWICH_MAX_M and _model_traces_contract_bytes(n_sources, m) <= _SMEM_BLOCK_MAX


def _check_model_traces(Lamb: torch.Tensor, H: torch.Tensor, XX: torch.Tensor) -> None:
    name = "model_traces"
    _require(Lamb.dim() == 3, f"{name}: Lamb must be (N, I, T), got {tuple(Lamb.shape)}")
    N, I, T = Lamb.shape
    _require(
        H.dim() == 4 and H.shape[:2] == (N, I) and H.shape[-1] == H.shape[-2],
        f"{name}: H must be (N, I, m, m) with Lamb {tuple(Lamb.shape)}, got {tuple(H.shape)}",
    )
    m = H.shape[-1]
    _require(
        tuple(XX.shape) == (I, T, m, m),
        f"{name}: XX {tuple(XX.shape)} does not match Lamb {tuple(Lamb.shape)} and H {tuple(H.shape)}",
    )
    _require(Lamb.dtype == torch.float32, f"{name}: the kernel takes float32 Lamb, got {Lamb.dtype}")
    _require(
        H.dtype == XX.dtype == torch.complex64, f"{name}: the kernel takes complex64 H and XX, got {H.dtype}, {XX.dtype}"
    )
    _require(
        Lamb.is_contiguous() and H.is_contiguous() and XX.is_contiguous(), f"{name}: inputs must be contiguous"
    )
    _require(min(N, I, T) >= 1, f"{name}: empty input {tuple(Lamb.shape)}")
    _require(1 <= m <= _SANDWICH_MAX_M, f"{name}: the kernel takes m <= {_SANDWICH_MAX_M}, got m={m}")
    _require(
        model_traces_takes(N, m), f"{name}: N={N}, m={m} exceeds the shared memory of one block"
    )
    _check_cuda(name, Lamb, H, XX)


def model_traces(
    Lamb: torch.Tensor,
    H: torch.Tensor,
    XX: torch.Tensor,
    eps: float = 1e-10,
    tiny: float = _GJ_TINY,
    outputs: str = "all",
) -> Tuple[torch.Tensor, ...]:
    """Fused dense-MNMF model pass ``(t1, t2, P, Q)``; kernel on CUDA, :func:`model_traces_plain` on CPU.

    Shapes and ``outputs`` as :func:`model_traces_plain`. The kernel takes
    float32 ``Lamb``, complex64 ``H`` and ``XX`` and ``m <= 16``, and writes
    no ``(I, T, m, m)`` intermediate to device memory; ``P`` and ``Q`` pass
    through a workspace of per-chunk partial sums
    (:func:`model_traces_geometry`), added in chunk order.
    """
    if _on_cpu(Lamb, H, XX):
        return model_traces_plain(Lamb, H, XX, eps, tiny, outputs)
    traces, sums = _model_traces_outputs(outputs)
    _check_model_traces(Lamb, H, XX)
    N, I, T = Lamb.shape
    m = H.shape[-1]
    geometry = model_traces_geometry(N, I, T, m)
    lib, launch = _entry("model_traces")
    t1 = t2 = partial = P = Q = None
    if traces:
        t1, t2 = torch.empty_like(Lamb), torch.empty_like(Lamb)
    if sums:
        partial = torch.empty(geometry["workspace"], dtype=H.dtype, device=H.device)
        P, Q = torch.empty_like(H), torch.empty_like(H)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = launch(
        Lamb.data_ptr(), H.data_ptr(), XX.data_ptr(), ptr(t1), ptr(t2), ptr(partial), ptr(P), ptr(Q),
        N, I, T, m, geometry["chunk"], float(eps), float(tiny), Lamb.device.index, _stream(Lamb.device),
    )
    _build.check(lib, "model_traces", status)
    model_traces.launches += 1
    if not sums:
        return t1, t2
    return (t1, t2, P, Q) if traces else (P, Q)


model_traces.launches = 0
