"""The cross-bin hook: partial reductions summed over the bin group in one ``all_reduce``.

In the JAX package the XLA partitioner inserts an all-reduce wherever a
step reduces over the sharded bin axis (the Laplace norm of IVA, the NMF
activation contractions, the power normalization). The port's steps call
the hook there instead: each step takes ``bin_sum=None`` and, given a
:class:`BinAllReduce`, sums its partials over the bin group; with
``None`` the step runs its single-device code unchanged. This module
imports torch alone, so the steps of :mod:`ssspy_tpu_torch.ops` can use it
without importing the runners.
"""

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["BinAllReduce", "all_reduce_sum"]


def all_reduce_sum(tensors: Sequence[torch.Tensor], group=None) -> Tuple[torch.Tensor, ...]:
    """The sums of ``tensors`` over ``group``, through one flattened ``all_reduce``.

    Complex tensors travel as their real pairs; every tensor must share one
    real dtype (complex64 with float32, complex128 with float64). The
    tensors are not modified; the sums come back in their shapes and dtypes.
    A failed collective raises, as ``dist.all_reduce`` does.
    """
    reals = [torch.view_as_real(t) if t.is_complex() else t for t in tensors]
    dtypes = {r.dtype for r in reals}
    if len(dtypes) != 1:
        raise ValueError(f"all_reduce_sum takes one real dtype, got {sorted(map(str, dtypes))}")
    flat = torch.cat([r.reshape(-1) for r in reals])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, offset = [], 0
    for t, r in zip(tensors, reals):
        piece = flat[offset : offset + r.numel()].view(r.shape)
        offset += r.numel()
        out.append(torch.view_as_complex(piece) if t.is_complex() else piece)
    return tuple(out)


class BinAllReduce:
    """The hook of one bin group: ``hook(*partials)`` returns their sums over the group.

    ``shards`` is the group's size. Each call issues one ``all_reduce``,
    whatever the number of partials, and adds one to ``calls``: a runner's
    steps call it once per intrinsic cross-bin reduction, with the partials
    of every utterance the rank holds stacked into the same call.
    """

    def __init__(self, group, shards: int):
        self.group = group
        self.shards = shards
        self.calls = 0

    def __call__(self, *partials: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        self.calls += 1
        return all_reduce_sum(partials, group=self.group)
