"""Time-domain ICA: the gradient step on real waveforms, one utterance or a batch.

Counterpart of the step of ``ssspy_tpu.bss.ica.GradICABase`` and of
``ssspy_tpu.parallel.make_batched_ica_runner`` (parallel/__init__.py:881-887)
(reference ssspy/bss/ica.py:406-708). The ICA classes call it with their
score function, the runner with the Laplace score ``sign``. No kernel.
"""

from typing import Callable

import torch

__all__ = ["grad_ica_step"]


def grad_ica_step(
    X: torch.Tensor, W: torch.Tensor, score_fn: Callable, step_size: float = 1e-1, is_holonomic: bool = False,
    natural: bool = False,
) -> torch.Tensor:
    """One Grad/NaturalGrad ICA iteration of ``W (M, M)`` on real ``X (M, T)``.

    ``PhiY = score_fn(Y) Y^T / T``; the direction ``PhiY - I`` (holonomic)
    or ``PhiY`` off the diagonal, applied to ``W`` (natural) or to
    ``W^-T`` (one ``solve_ex`` of ``W^T Z = I``, where the JAX runner takes
    ``inv``). A batch ``X (B, M, T)``, ``W (B, M, M)`` takes one step per
    utterance: as one batched step (batched products over the long frame
    axis) it ran 3.3x slower per utterance than the single utterance's step
    on an H100 (chip_smoke ``[parallel]``; PERF.md, section 6).
    """
    if X.dim() > 2:
        return torch.stack([
            grad_ica_step(x, w, score_fn, step_size=step_size, is_holonomic=is_holonomic, natural=natural)
            for x, w in zip(X, W)
        ])
    Y = W @ X
    PhiY = (score_fn(Y) @ Y.T) / Y.shape[-1]
    eye = torch.eye(W.shape[0], dtype=W.dtype, device=W.device)
    direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
    right = W if natural else torch.linalg.solve_ex(W.T, eye)[0]
    return W - step_size * (direction @ right)
