"""Multi-device runners over a ``(dp, bin)`` layout of ranks, on ``torch.distributed``.

Counterpart of :mod:`ssspy_tpu.parallel` (parallel/__init__.py:1-17). The
JAX package lays its devices on a 2-D mesh and lets XLA partition one
program; here each rank is a process of its own that runs its own Python
loop on its own card, since every fast path of the port is paced by the
host:

- ``dp``: data parallelism over an utterance batch. Each row of ranks
  takes its slice of the batch; no collective crosses it inside the loop.
- ``bin``: sequence-style parallelism over frequency bins. Each rank of a
  row takes a contiguous slice of the bins (zero-padded up to a multiple of
  the row's size). The per-bin updates need no communication; the steps'
  intrinsic cross-bin reductions go through the hook of
  :mod:`ssspy_tpu_torch.parallel.collectives`, one ``all_reduce`` over the
  row each (the all-reduces per iteration equal the JAX package's pins,
  tests/parallel/test_hlo_collectives.py:241-262).

After the loop each runner assembles the global result once: every rank
writes its block into a zero-filled buffer and one ``all_reduce`` over the
world sums them, so every rank returns the whole result, on its own
device. The runners take the process group the caller initialized and
never choose a backend: NCCL across cards, gloo on the CPU or for several
ranks on one card. With no process group, :func:`make_layout` gives the
``(1, 1)`` layout on the caller's device and no collective is issued.

A rank's steps take its utterances on a leading axis: the steps fold them
into the bin axis where a kernel takes the fold for free and loop over
them otherwise (``ops/iva_steps.py``, ``ops/mnmf_steps.py``,
``ops/ipsdta_steps.py``, ``ops/fdica_steps.py``,
``ops/fixed_point_iva_steps.py``, ``ops/prox_steps.py``,
``ops/fast_mnmf_steps.py``); cACGMM, whose EM is per bin, folds its whole
state into the bins once, before the loop. Time-domain ICA has no bin
axis: its runner splits the batch over ``dp`` alone.

One runner departs from the JAX package's collective count: HVA's cepstral
mask gathers the row's floored log magnitude in one all-reduce and runs
the whole-axis ``irfft`` on every rank, where the JAX runner's DFT matmuls
all-reduce twice (:func:`make_batched_hva_runner`).
"""

import math
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import DEFAULT_DEVICE, resolve_device
from .collectives import BinAllReduce, all_reduce_sum

__all__ = [
    "Layout",
    "layout_shape",
    "make_layout",
    "shard_batched_run",
    "shard_state_run",
    "shard_pytree_run",
    "make_batched_auxiva_runner",
    "make_batched_auxiva_ip2_runner",
    "make_batched_auxiva_iss1_runner",
    "make_batched_auxiva_iss2_runner",
    "make_batched_auxiva_ipa_runner",
    "make_batched_ilrma_runner",
    "make_batched_gauss_mnmf_runner",
    "make_batched_cacgmm_runner",
    "make_batched_ipsdta_runner",
    "make_batched_auxiva_wave_runner",
    "make_batched_fast_iva_runner",
    "make_batched_faster_iva_runner",
    "make_batched_fdica_runner",
    "make_batched_grad_iva_runner",
    "make_batched_grad_fdica_runner",
    "make_batched_fast_mnmf_runner",
    "make_batched_pds_iva_runner",
    "make_batched_admm_iva_runner",
    "make_batched_hva_runner",
    "make_batched_ica_runner",
]


def layout_shape(world_size: int, shape: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """``(dp, bin)`` for ``world_size`` ranks: as even a factorization as there is, ``dp <= bin``.

    1 -> (1, 1), 2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4), as ``make_mesh``
    factorizes devices (parallel/__init__.py:71-93); ``shape`` overrides it
    and must multiply to ``world_size``.
    """
    if shape is None:
        dp = max(c for c in range(1, math.isqrt(world_size) + 1) if world_size % c == 0)
        shape = (dp, world_size // dp)
    shape = (int(shape[0]), int(shape[1]))
    if shape[0] < 1 or shape[1] < 1 or shape[0] * shape[1] != world_size:
        raise ValueError(f"layout shape {shape} does not hold {world_size} ranks")
    return shape


@dataclass(frozen=True)
class Layout:
    """A rank's place in the ``(dp, bin)`` layout and its bin group.

    ``rank = dp_index * shape[1] + bin_index`` (row-major, as the JAX mesh
    reshapes its devices). ``bin_sum`` is the hook of the rank's row (the
    same utterances, the bins split), ``None`` when the row is one rank;
    no collective crosses ``dp``. ``distributed`` is False for the ``(1,
    1)`` layout without a group.
    """

    shape: Tuple[int, int]
    rank: int
    device: torch.device
    distributed: bool = False
    bin_sum: Optional[BinAllReduce] = None

    @property
    def dp_index(self) -> int:
        return self.rank // self.shape[1]

    @property
    def bin_index(self) -> int:
        return self.rank % self.shape[1]


def _rank_device(device) -> torch.device:
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# the calling rank's bin groups by layout shape, and the default process group they were made under
_bin_groups: dict = {}
_bin_groups_world = None


def _bin_group(n_dp: int, n_bin: int):
    """The calling rank's row of ``n_bin`` ranks, made once per process group and shape.

    ``dist.new_group`` is collective over the whole group, so the first
    call for a shape must come from every rank together; later calls
    return the group made then, and issue nothing.
    """
    global _bin_groups_world
    if _bin_groups_world is not dist.group.WORLD:  # a new process group: the old one's groups went with it
        _bin_groups.clear()
        _bin_groups_world = dist.group.WORLD
    if (n_dp, n_bin) not in _bin_groups:
        row = dist.get_rank() // n_bin
        for r in range(n_dp):
            group = dist.new_group([r * n_bin + b for b in range(n_bin)])
            if r == row:
                _bin_groups[(n_dp, n_bin)] = group
    return _bin_groups[(n_dp, n_bin)]


def make_layout(world_size: Optional[int] = None, shape: Optional[Tuple[int, int]] = None, device=DEFAULT_DEVICE) -> Layout:
    """The calling rank's :class:`Layout`; the counterpart of ``make_mesh``.

    ``world_size=None`` takes the initialized process group's size, or 1
    without one; ``world_size=1`` is the ``(1, 1)`` layout on ``device``
    whether a group is initialized or not, and issues no collective. Any
    other size must be the group's. The first layout of a shape under a
    process group makes its bin groups with ``dist.new_group``, so every
    rank makes it together; later ones reuse them. ``device``: the rank's
    device (the card by default; ``"cuda"`` without an index is the
    current device, which a rank sets with ``torch.cuda.set_device``).
    """
    device = _rank_device(device)
    initialized = dist.is_available() and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if initialized else 1
    if world_size == 1:
        return Layout(shape=layout_shape(1, shape), rank=0, device=device)
    if not initialized:
        raise RuntimeError(f"a layout of {world_size} ranks needs torch.distributed.init_process_group first")
    if world_size != dist.get_world_size():
        raise ValueError(f"world_size={world_size}, but the process group holds {dist.get_world_size()} ranks")
    n_dp, n_bin = layout_shape(world_size, shape)
    bin_sum = BinAllReduce(_bin_group(n_dp, n_bin), n_bin) if n_bin > 1 else None
    return Layout(shape=(n_dp, n_bin), rank=dist.get_rank(), device=device, distributed=True, bin_sum=bin_sum)


# ---- the rank's block and the global result ------------------------------------------------


@dataclass(frozen=True)
class _Rows:
    """The rank's utterances ``[b0, b0 + n_local)`` of ``n_batch``."""

    b0: int
    n_local: int
    n_batch: int


@dataclass(frozen=True)
class _Extent:
    """The rank's ``size`` entries of a bin (or block) axis of ``n`` real ones: ``real`` of them from ``first``, then padding."""

    first: int
    real: int
    size: int

    def mask(self, device) -> Optional[torch.Tensor]:
        """``(size,)`` True on the real entries; ``None`` when every entry is real."""
        if self.real == self.size:
            return None
        return torch.arange(self.size, device=device) < self.real


def _rows(layout: Layout, n_batch: int) -> _Rows:
    n_dp = layout.shape[0]
    if n_batch % n_dp:
        raise ValueError(f"a batch of {n_batch} utterances does not divide over dp = {n_dp}")
    n_local = n_batch // n_dp
    return _Rows(layout.dp_index * n_local, n_local, n_batch)


def _extent(layout: Layout, n: int) -> _Extent:
    """The rank's part of an axis of ``n``, zero-padded up to a multiple of the row's ranks (``_pad_to_multiple``, :149)."""
    size = -(-n // layout.shape[1])
    start = layout.bin_index * size
    return _Extent(min(start, n), max(0, min(size, n - start)), size)


def _identity_like(shape, dtype, device) -> torch.Tensor:
    """Identity demixing filters of ``shape (..., N, M)``."""
    return torch.eye(shape[-2], shape[-1], dtype=dtype, device=device).expand(shape)


def _local(a: torch.Tensor, layout: Layout, rows: _Rows, bin_axis: Optional[int], identity: bool = False,
           pad: bool = True) -> torch.Tensor:
    """The rank's slice of global ``a`` (utterances on axis 0) on its device, the bin axis padded to the rank's size.

    Padded bins are zeros, or identity filters with ``identity``
    (``_identity_pad``, :160-176: a padded bin's system stays well-posed;
    its updates never reach a real bin and are dropped); ``pad=False``
    keeps the real bins alone.
    """
    a = a.narrow(0, rows.b0, rows.n_local)
    if bin_axis is None:
        return a.to(layout.device).contiguous()
    ext = _extent(layout, a.shape[bin_axis])
    a = a.narrow(bin_axis, ext.first, ext.real).to(layout.device)
    n_pad = ext.size - ext.real if pad else 0
    if n_pad:
        shape = list(a.shape)
        shape[bin_axis] = n_pad
        fill = (_identity_like(shape, a.dtype, a.device) if identity
                else torch.zeros(shape, dtype=a.dtype, device=a.device))
        a = torch.cat([a, fill], dim=bin_axis)
    return a.contiguous()


def _assemble(layout: Layout, rows: _Rows, leaves: Sequence[torch.Tensor], bin_axes: Sequence[Optional[int]],
              n_bins: Sequence[Optional[int]]) -> Tuple[torch.Tensor, ...]:
    """The global leaves from every rank's, each sliced to its ``n_bins`` real bins: one ``all_reduce`` over the world.

    Every rank writes its block into zero-filled buffers of the global
    shapes and the buffers are summed; a leaf without a bin axis is the same
    on every rank of a row and is written by the row's first rank alone.
    Without a group the rank's leaves are the result.
    """
    exts = [None if axis is None else _extent(layout, n) for axis, n in zip(bin_axes, n_bins)]
    leaves = [leaf if ext is None else leaf.narrow(axis, 0, ext.real) for leaf, axis, ext in zip(leaves, bin_axes, exts)]
    if not layout.distributed:
        return tuple(leaves)
    buffers = []
    for leaf, axis, n, ext in zip(leaves, bin_axes, n_bins, exts):
        shape = list(leaf.shape)
        shape[0] = rows.n_batch
        if axis is not None:
            shape[axis] = n
        buffer = torch.zeros(shape, dtype=leaf.dtype, device=leaf.device)
        target = buffer.narrow(0, rows.b0, rows.n_local)
        if axis is not None:
            target.narrow(axis, ext.first, ext.real).copy_(leaf)
        elif layout.bin_index == 0:
            target.copy_(leaf)
        buffers.append(buffer)
    return all_reduce_sum(buffers)


# ---- the generic runners --------------------------------------------------------------------


Step = Callable[..., Tuple[torch.Tensor, ...]]


def shard_pytree_run(
    layout: Layout,
    step_fn: Step,
    *,
    x_bin_axis: Optional[int],
    carry_bin_axes: Sequence[Optional[int]],
    identity_leaves: Sequence[int] = (0,),
    bin_mask: bool = False,
    precompute: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Callable:
    """``run(X, carry, n_iter)`` over ``layout``: the counterpart of ``shard_pytree_run`` (:552-637).

    ``X`` (or ``None``) and the ``carry`` leaves are global tensors or
    arrays, utterances on axis 0; ``x_bin_axis`` and ``carry_bin_axes``
    name each one's bin axis (``None``: no bin axis, the leaf is the same
    on every rank of a row). Each rank takes its block (:func:`_local`:
    the leaves in ``identity_leaves`` are identity-padded, the others
    zero-padded), runs ``step_fn(X, carry, bin_sum)`` ``n_iter`` times as a
    plain loop (``bin_sum=`` the layout's hook), and the result is
    assembled once (:func:`_assemble`). With ``bin_mask`` the step also
    gets ``bin_mask=`` the rank's real bins (``None`` without padding).
    Each leaf is padded and sliced back on its own bin axis, as
    ``_pad_carry_leaves`` (:371-390) pads it. Padding is exact for per-bin
    updates; a step whose normalization averages over bins (ILRMA's)
    averages over the padded bins too, as the JAX runner does (:574-579).
    ``precompute(X_local)``, the counterpart of ``precompute_fn``
    (:558-561), runs once per rank on its block of ``X``, before the loop,
    and the step gets its result as ``pre=`` (a loop-invariant operator,
    ADMM's quadratic inverse). Returns the carry's leaves as a tuple.
    """

    def run(X, carry, n_iter: int):
        leaves = [torch.as_tensor(leaf) for leaf in carry]
        n_bins = [None if axis is None else leaf.shape[axis] for leaf, axis in zip(leaves, carry_bin_axes)]
        rows = _rows(layout, leaves[0].shape[0])
        X_local = None
        if X is not None:
            X = torch.as_tensor(X)
            X_local = _local(X, layout, rows, x_bin_axis)
        state = tuple(
            _local(leaf, layout, rows, axis, identity=i in identity_leaves)
            for i, (leaf, axis) in enumerate(zip(leaves, carry_bin_axes))
        )
        extra = {}
        if bin_mask:
            extra["bin_mask"] = _extent(layout, X.shape[x_bin_axis]).mask(layout.device)
        if precompute is not None:
            extra["pre"] = precompute(X_local)
        for _ in range(n_iter):
            state = tuple(step_fn(X_local, state, layout.bin_sum, **extra))
        return _assemble(layout, rows, state, carry_bin_axes, n_bins)

    return run


def shard_batched_run(layout: Layout, step_fn: Step) -> Callable:
    """``run(X, W, n_iter) -> W`` with ``step_fn(X, W, bin_sum) -> W`` (``shard_batched_run``, :184-239).

    ``X (B, M, I, T)``, ``W (B, I, N, M)``; ``W`` is identity-padded.
    """
    run = shard_pytree_run(
        layout, lambda X, carry, bin_sum: (step_fn(X, carry[0], bin_sum),), x_bin_axis=2, carry_bin_axes=(1,)
    )
    return lambda X, W, n_iter: run(X, (W,), n_iter)[0]


def shard_state_run(layout: Layout, step_fn: Step) -> Callable:
    """``run(Y, n_iter) -> Y`` for the demix-free state, ``step_fn(Y, bin_sum) -> Y`` (``shard_state_run``, :318-350).

    ``Y (B, N, I, T)``, zero-padded.
    """
    run = shard_pytree_run(
        layout, lambda X, carry, bin_sum: (step_fn(carry[0], bin_sum),),
        x_bin_axis=None, carry_bin_axes=(2,), identity_leaves=(),
    )
    return lambda Y, n_iter: run(None, (Y,), n_iter)[0]


def _layout(layout: Optional[Layout]) -> Layout:
    return make_layout() if layout is None else layout


# ---- the runners ------------------------------------------------------------------------------


def make_batched_auxiva_runner(layout: Optional[Layout] = None) -> Callable:
    """AuxIVA-IP1 (the main path): ``run(X (B, M, I, T), W (B, I, N, M), n_iter) -> W`` (:242-265).

    One all-reduce per iteration, the Laplace norm. K1 runs once per
    utterance, K1b once for all (folded into the bins).
    """
    from ..ops.iva_steps import auxiva_ip1_step

    return shard_batched_run(_layout(layout), lambda X, W, bin_sum: auxiva_ip1_step(X, W, bin_sum=bin_sum))


def make_batched_auxiva_ip2_runner(layout: Optional[Layout] = None) -> Callable:
    """AuxIVA-IP2 over the sequential pairs, the IP1 layout (:309-317). One all-reduce per pair."""
    from ..ops.iva_steps import auxiva_ip2_step

    return shard_batched_run(_layout(layout), lambda X, W, bin_sum: auxiva_ip2_step(X, W, bin_sum=bin_sum))


def make_batched_auxiva_iss1_runner(layout: Optional[Layout] = None) -> Callable:
    """AuxIVA-ISS1 on the demix-free state: ``run(Y (B, N, I, T), n_iter) -> Y`` (:353-362).

    One all-reduce per iteration; K2 once per utterance.
    """
    from ..ops.iva_steps import auxiva_iss1_step

    return shard_state_run(_layout(layout), lambda Y, bin_sum: auxiva_iss1_step(Y, bin_sum=bin_sum))


def make_batched_auxiva_iss2_runner(layout: Optional[Layout] = None) -> Callable:
    """AuxIVA-ISS2, the ISS1 layout (:393-399). One all-reduce per iteration."""
    from ..ops.iva_steps import auxiva_iss2_step

    return shard_state_run(_layout(layout), lambda Y, bin_sum: auxiva_iss2_step(Y, bin_sum=bin_sum))


def make_batched_auxiva_ipa_runner(layout: Optional[Layout] = None) -> Callable:
    """AuxIVA-IPA, the ISS1 layout (:424-436). One all-reduce per iteration; the sweep (K1, K6, K7) once per utterance."""
    from ..ops.iva_steps import auxiva_ipa_step

    return shard_state_run(_layout(layout), lambda Y, bin_sum: auxiva_ipa_step(Y, bin_sum=bin_sum))


def make_batched_ilrma_runner(layout: Optional[Layout] = None) -> Callable:
    """GaussILRMA-IP1: ``run(X (B, M, I, T), (W (B, I, N, M), T (B, N, I, K), V (B, N, K, T)), n_iter)`` (:640-665).

    ``W`` and ``T`` over bins, ``V`` on every rank of a row. Two
    all-reduces per iteration: the activation update and the power
    normalization, whose mean is over the padded bins (compare padded
    against padded, as the JAX runner documents).
    """
    from ..ops.ilrma_steps import gauss_ilrma_ip1_step

    return shard_pytree_run(
        _layout(layout), lambda X, c, bin_sum: gauss_ilrma_ip1_step(X, *c, bin_sum=bin_sum),
        x_bin_axis=2, carry_bin_axes=(1, 2, None),
    )


def make_batched_gauss_mnmf_runner(layout: Optional[Layout] = None, partitioning: bool = False) -> Callable:
    """Dense GaussMNMF: ``run(XX (B, I, T, M, M), (T, V, H[, Z]), n_iter)`` (:975-1061).

    ``T (B, N, I, K)`` (``(B, I, K)`` with ``partitioning``) and ``H (B, N,
    I, M, M)`` over bins, ``V`` and ``Z`` on every rank of a row. Padded
    bins are masked (``gauss_mnmf_step``'s ``bin_mask``), so a padded run
    follows the unpadded trajectory. One all-reduce per iteration (the
    activation update), two with ``partitioning`` (and the latent). K5 once
    per utterance and pass.
    """
    from ..ops.mnmf_steps import gauss_mnmf_step

    def step(XX, carry, bin_sum, bin_mask):
        return gauss_mnmf_step(XX, *carry, bin_mask=bin_mask, bin_sum=bin_sum)

    axes = (1, None, 2, None) if partitioning else (2, None, 2)
    return shard_pytree_run(
        _layout(layout), step, x_bin_axis=1, carry_bin_axes=axes, identity_leaves=(), bin_mask=True
    )


def make_batched_cacgmm_runner(layout: Optional[Layout] = None) -> Callable:
    """cACGMM: ``run(Z (B, M, I, T), (alpha (B, N, I), B (B, N, I, M, M)), n_iter)`` (:692-720).

    Both EM stages are per bin: no collective. The rank's utterances are
    folded into its bins once, before the loop (``Z (M, B I, T)``), so K7
    runs once per E-step and M-step for all of them. Nothing couples the
    bins, so a rank takes its real bins alone, unpadded (the JAX runner pads
    with zeros, whose bins go non-finite there; ``torch.linalg.eigh``, the
    complex128 route, raises on them).
    """
    from ..ops import cacgmm_steps

    layout = _layout(layout)

    def run(Z, carry, n_iter: int):
        Z, alpha, B = (torch.as_tensor(a) for a in (Z,) + tuple(carry))
        rows = _rows(layout, Z.shape[0])
        real = _extent(layout, Z.shape[2]).real
        # the rank's utterances folded into its bins: (M, B I, T), (N, B I), (N, B I, M, M)
        Z_f, alpha_f, B_f = (_local(a, layout, rows, 2, pad=False).transpose(0, 1).flatten(1, 2) for a in (Z, alpha, B))
        for _ in range(n_iter if real else 0):
            alpha_f, B_f = cacgmm_steps.step(Z_f, alpha_f, B_f)
        alpha, B_out = (a.unflatten(1, (rows.n_local, real)).transpose(0, 1) for a in (alpha_f, B_f))
        return _assemble(layout, rows, (alpha, B_out), (2, 2), (Z.shape[2],) * 2)

    return run


def make_batched_ipsdta_runner(layout: Optional[Layout] = None) -> Callable:
    """GaussIPSDTA (MM + VCD): ``run(X (B, M, I, T), (W, T_parts, V), n_iter)`` over the block axis (:754-786).

    ``W (B, I, N, M)`` over bins; the basis, one part ``(B, N, K, B_p, J,
    J)``, over its block axis, so whole ``J x J`` blocks stay on a rank;
    ``V (B, N, K, T)`` on every rank of a row. Raises unless the bins divide
    into the blocks (one part) and both divide over the row, as the JAX
    runner requires. One all-reduce per iteration (the activation update
    with the normalization's traces).
    K3 and K7 once for all utterances, the VCD sweep once per utterance.
    """
    from ..ops.ipsdta_steps import ipsdta_vcd_step

    layout = _layout(layout)
    shards = layout.shape[1]

    def step(X, carry, bin_sum):
        W, T_part, V = carry
        W, (T_part,), V = ipsdta_vcd_step(X, W, [T_part], V, bin_sum=bin_sum)
        return W, T_part, V

    inner = shard_pytree_run(layout, step, x_bin_axis=2, carry_bin_axes=(1, 3, None))

    def run(X, carry, n_iter: int):
        W, T_parts, V = carry
        if len(T_parts) != 1:
            raise ValueError("the IPSDTA runner takes one basis part: the bins must divide into the blocks")
        n_bins, n_blocks = torch.as_tensor(X).shape[2], torch.as_tensor(T_parts[0]).shape[3]
        if n_bins % shards or n_blocks % shards:
            raise ValueError(f"{n_bins} bins and {n_blocks} blocks must both divide over {shards} bin shards")
        W, T_part, V = inner(X, (W, T_parts[0], V), n_iter)
        return W, [T_part], V

    return run


def make_batched_auxiva_wave_runner(layout: Optional[Layout] = None, n_fft: int = 512,
                                    hop_length: Optional[int] = None) -> Callable:
    """Waveform-to-waveform AuxIVA-IP1: ``run(waveforms (B, M, n_samples), n_iter) -> (B, N, n_samples)`` (:1064-1123).

    Each row's STFT of its utterances; the rank's bins, the IP1 loop (one
    all-reduce per iteration), projection back onto channel 0 per bin; then
    once, after the loop, the row's bins are gathered (one all-reduce over
    the row) for the iSTFT, and the rows' waveforms assembled.
    """
    from ..ops.iva_steps import auxiva_ip1_step, separate
    from ..transform import istft, stft

    layout = _layout(layout)
    hop = n_fft // 2 if hop_length is None else hop_length

    def run(waveforms, n_iter: int):
        x = torch.as_tensor(waveforms)
        rows = _rows(layout, x.shape[0])
        n_bins, n_samples = n_fft // 2 + 1, x.shape[-1]
        ext = _extent(layout, n_bins)
        X = stft(x.narrow(0, rows.b0, rows.n_local).to(layout.device), n_fft=n_fft, hop_length=hop, device=layout.device)
        X = _local(X, layout, _Rows(0, rows.n_local, rows.n_local), 2)  # the rank's bins, zero-padded
        n_channels = X.shape[1]
        W = _identity_like((rows.n_local, ext.size, n_channels, n_channels), X.dtype, X.device).contiguous()
        for _ in range(n_iter):
            W = auxiva_ip1_step(X, W, bin_sum=layout.bin_sum)
        W = W * torch.linalg.inv_ex(W)[0][..., 0, :, None]  # projection back onto channel 0
        Y = separate(X, W).narrow(2, 0, ext.real)  # (B_local, N, real bins, T)
        if layout.bin_sum is not None:  # the row's bins, gathered once for the iSTFT through the hook
            full = torch.zeros(Y.shape[:2] + (n_bins,) + Y.shape[3:], dtype=Y.dtype, device=Y.device)
            full.narrow(2, ext.first, ext.real).copy_(Y)
            (Y,) = layout.bin_sum(full)
        y = istft(Y, n_fft=n_fft, hop_length=hop, length=n_samples, device=layout.device)
        return _assemble(layout, rows, [y], [None], [None])[0]

    return run


# ---- the runners of the fixed-point, gradient, FDICA, prox and FastGaussMNMF families ------------


def make_batched_fast_iva_runner(layout: Optional[Layout] = None, polar_impl: str = "eigh") -> Callable:
    """FastIVA on the whitened mixture: ``run(Z (B, M, I, T), W (B, I, N, M), n_iter) -> W`` (:439-451).

    ``Z`` is pre-whitened (``fixed_point_iva_steps.whiten_spectrogram`` of
    each utterance), the IP1 layout. One all-reduce per iteration, the
    contrast's norm over the bins; the fixed-point update and the polar
    factor (K7, once for all utterances; ``polar_impl`` as
    ``fast_iva_step`` takes it) are per bin.
    """
    from ..ops.fixed_point_iva_steps import fast_iva_step

    return shard_batched_run(
        _layout(layout), lambda Z, W, bin_sum: fast_iva_step(Z, W, polar_impl=polar_impl, bin_sum=bin_sum)
    )


def make_batched_faster_iva_runner(layout: Optional[Layout] = None, eig_impl: str = "eigh") -> Callable:
    """FasterIVA, FastIVA's layout (:454-463). One all-reduce per iteration.

    The per-source covariance (K1, once per utterance), its top
    eigenvectors and the polar factor (K7 twice, once for all utterances;
    ``eig_impl`` as ``faster_iva_step`` takes it) are per bin.
    """
    from ..ops.fixed_point_iva_steps import faster_iva_step

    return shard_batched_run(
        _layout(layout), lambda Z, W, bin_sum: faster_iva_step(Z, W, eig_impl=eig_impl, bin_sum=bin_sum)
    )


def make_batched_fdica_runner(layout: Optional[Layout] = None, spatial_algorithm: str = "IP1") -> Callable:
    """AuxLaplaceFDICA, IP1 (or ``"IP"``) or IP2, the IP1 layout: ``run(X, W, n_iter) -> W`` (:481-499).

    FDICA's weights are per scalar: nothing reduces over the bins and no
    collective runs in the loop. IP1 launches K1 with ``(N, I, T)`` weights
    once per utterance and K1b once for all; IP2 K1 at two sources once per
    pair and utterance. No permutation alignment runs here, as in the JAX
    runner.
    """
    from ..ops.fdica_steps import aux_laplace_fdica_ip1_step, aux_laplace_fdica_ip2_step

    step = {"IP": aux_laplace_fdica_ip1_step, "IP1": aux_laplace_fdica_ip1_step,
            "IP2": aux_laplace_fdica_ip2_step}[spatial_algorithm]
    return shard_batched_run(_layout(layout), lambda X, W, bin_sum: step(X, W))


def make_batched_grad_iva_runner(layout: Optional[Layout] = None, step_size: float = 1e-1, is_holonomic: bool = True,
                                 natural: bool = False) -> Callable:
    """Grad/NaturalGrad Laplace IVA, the IP1 layout (:502-526). One all-reduce per iteration, the score's norm.

    The direction and the vanilla gradient's ``W^-H`` (``solve_ex``) are per
    bin; no kernel.
    """
    from ..ops.iva_steps import grad_laplace_iva_step

    def step(X, W, bin_sum):
        return grad_laplace_iva_step(X, W, step_size=step_size, is_holonomic=is_holonomic, natural=natural,
                                     bin_sum=bin_sum)

    return shard_batched_run(_layout(layout), step)


def make_batched_grad_fdica_runner(layout: Optional[Layout] = None, step_size: float = 1e-1,
                                   is_holonomic: bool = True, natural: bool = False) -> Callable:
    """Grad/NaturalGrad Laplace FDICA, the IP1 layout (:529-549): per-scalar scores, no collective, no kernel."""
    from ..ops.fdica_steps import grad_laplace_fdica_step

    def step(X, W, bin_sum):
        return grad_laplace_fdica_step(X, W, step_size=step_size, is_holonomic=is_holonomic, natural=natural)

    return shard_batched_run(_layout(layout), step)


def make_batched_fast_mnmf_runner(layout: Optional[Layout] = None) -> Callable:
    """FastGaussMNMF (IP1 diagonalizer): ``run(X (B, M, I, T), (Q, T, V, D), n_iter)`` (:721-751).

    ``Q (B, I, M, M)`` (identity-padded), ``T (B, N, I, K)`` and ``D (B,
    I, N, M)`` over bins, ``V (B, N, K, T)`` on every rank of a row. Two
    all-reduces per iteration: the activation update and the power
    normalization, whose mean is over the padded bins (compare padded
    against padded, as the JAX runner documents). K1 with per-channel
    weights once per utterance, K1b once for all.
    """
    from ..ops.fast_mnmf_steps import fast_gauss_mnmf_step

    return shard_pytree_run(
        _layout(layout), lambda X, c, bin_sum: fast_gauss_mnmf_step(X, *c, bin_sum=bin_sum),
        x_bin_axis=2, carry_bin_axes=(1, 2, None, 1),
    )


def make_batched_pds_iva_runner(layout: Optional[Layout] = None, mu1: float = 1.0, mu2: float = 1.0,
                                relaxation: float = 1.0) -> Callable:
    """PDSIVA: ``run(X (B, M, I, T), (W (B, I, N, M), Y (B, N, I, T)), n_iter)`` (:785-816).

    One all-reduce per iteration, the L21 group norm over the bins, where
    zero-padded bins are exactly neutral; the log-det prox (K7, once for all
    utterances) is per bin.
    """
    from ..ops.prox_steps import pds_iva_step

    def step(X, carry, bin_sum):
        return pds_iva_step(X, *carry, mu1=mu1, mu2=mu2, relaxation=relaxation, bin_sum=bin_sum)

    return shard_pytree_run(_layout(layout), step, x_bin_axis=2, carry_bin_axes=(1, 2))


def make_batched_admm_iva_runner(layout: Optional[Layout] = None, rho: float = 1.0,
                                 relaxation: float = 1.0) -> Callable:
    """ADMMIVA: ``run(X, (W, V, Vt, Y, Yt), n_iter)`` (:819-857).

    Filter-shaped ``W``, ``V``, ``Y`` ``(B, I, N, M)`` and spectrogram-shaped
    ``Vt``, ``Yt`` ``(B, N, I, T)`` over bins; ``W`` and ``V`` are
    identity-padded, as the JAX runner's ``identity_leaves=(0, 1)``. ``W`` is
    recomputed each iteration from the quadratic subproblem, whose inverse
    ``(X X^H + I)^-1`` each rank takes once, before the loop, on its own
    bins (``precompute``). One all-reduce per iteration, the L21 group norm;
    the log-det prox (K7, once for all utterances) is per bin.
    """
    from ..ops.prox_steps import admm_iva_step, admm_quad_inv

    def step(X, carry, bin_sum, pre):
        return admm_iva_step(X, *carry[1:], rho=rho, relaxation=relaxation, quad_inv=pre, bin_sum=bin_sum)

    return shard_pytree_run(
        _layout(layout), step, x_bin_axis=2, carry_bin_axes=(1, 1, 2, 1, 2), identity_leaves=(0, 1),
        precompute=admm_quad_inv,
    )


def make_batched_hva_runner(layout: Optional[Layout] = None, mu1: float = 1.0, mu2: float = 1.0,
                            relaxation: float = 1.0, attenuation: Optional[float] = None,
                            mask_iter: int = 1) -> Callable:
    """HVA (masking PDS): ``run(X, (W, Y), n_iter)`` with PDSIVA's layout (:860-973).

    The harmonic mask is a cepstral transform over the whole bin axis (two
    ``irfft``), which a rank that holds a slice of the bins cannot run.
    The JAX runner writes the transform as DFT matmuls whose partial sums
    XLA all-reduces, twice per iteration (its pin,
    tests/parallel/test_hlo_collectives.py:259). This runner departs from
    that: each iteration gathers the row's floored log magnitude with one
    all-reduce (every rank writes its real bins into a zero-filled buffer of
    the global bin count; the sum is exact) and every rank runs the
    unchanged cuFFT mask over the whole axis and keeps its own bins
    (``prox_steps.gathered_harmonic_mask``). So its pin is 1, not the JAX
    package's 2; it moves as many bytes as the JAX program's larger
    all-reduce, and keeps cuFFT in place of the TPU's DFT as matmuls. The
    padded bins' spectrograms stay zero and their masks are dropped, so
    padding is exact. The log-det prox (K7, once for all utterances) is per
    bin.
    """
    from ..ops.prox_steps import hva_pds_step

    layout = _layout(layout)

    def run(X, carry, n_iter: int):
        n_bins = torch.as_tensor(X).shape[2]
        bins = (_extent(layout, n_bins).first, n_bins)

        def step(X_local, c, bin_sum):
            return hva_pds_step(X_local, *c, mu1=mu1, mu2=mu2, relaxation=relaxation, attenuation=attenuation,
                                mask_iter=mask_iter, bin_sum=bin_sum, bins=bins)

        return shard_pytree_run(layout, step, x_bin_axis=2, carry_bin_axes=(1, 2))(X, carry, n_iter)

    return run


def make_batched_ica_runner(layout: Optional[Layout] = None, variant: str = "natural_grad", step_size: float = 1e-1,
                            is_holonomic: bool = False) -> Callable:
    """Time-domain Laplace ICA: ``run(X (B, M, T) real, W (B, M, M), n_iter) -> W`` (:860-903).

    No bin axis: the batch splits over ``dp`` alone, no collective runs,
    and the ranks of a row run the same utterances (the row's first rank
    writes the result). ``variant``: ``"grad"`` (the direction applied to
    ``W^-T``, by ``solve_ex``) or ``"natural_grad"`` (to ``W``), the step
    ``ops.ica_steps.grad_ica_step`` with the Laplace score ``sign``. No
    kernel.
    """
    from ..ops.ica_steps import grad_ica_step

    natural = {"grad": False, "natural_grad": True}[variant]

    def step(X, carry, bin_sum):
        return (grad_ica_step(X, carry[0], torch.sign, step_size=step_size, is_holonomic=is_holonomic,
                              natural=natural),)

    run = shard_pytree_run(_layout(layout), step, x_bin_axis=None, carry_bin_axes=(None,), identity_leaves=())
    return lambda X, W, n_iter: run(X, (W,), n_iter)[0]
