"""Checkpoint / resume for separation runs.

Counterpart of :mod:`ssspy_tpu.utils.checkpoint`. A separator's warm start
is implicit in its ``__call__``: the keywords ``_reset`` takes become its
starting state, and ``initial_call=False`` skips the duplicate loss entry.
These helpers make it explicit: they take the state a method's class
declares (``warm_start_keys``: each key of ``_state`` and the ``__call__``
keyword that takes it back) to the host as numpy arrays, keep it in an
``.npz`` file, and feed it back through the keywords.

>>> iva = AuxLaplaceIVA(spatial_algorithm="IP")
>>> iva(spectrogram, n_iter=50)
>>> save_checkpoint("run.npz", iva)
>>> iva2 = AuxLaplaceIVA(spatial_algorithm="IP")
>>> resume(iva2, spectrogram, "run.npz", n_iter=50)   # iterations 51-100

A file holds the keywords by name (a tuple as ``name.0``, ``name.1``, ...)
and the loss history as ``loss``: the JAX package's layout, so that each
package's :func:`load_checkpoint` reads the other's files. Keys a class
does not declare are not kept: the input, and what ``_reset`` derives from
it (FastIVA's whitened ``Xw``, cACGMM's unit input and FastICA's whitened
input, both ``Z``, dense MNMF's ``XX``, ADMM's ``quad_inv``). The JAX
package's split-complex branch (planar ``[real, imag]`` states) has no
counterpart: the port's states are native complex. Resumed tensors go to
the separator's device.
"""

from typing import Dict

import numpy as np
import torch

__all__ = ["state_dict", "save_checkpoint", "load_checkpoint", "resume"]


def _host(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def state_dict(method) -> Dict[str, np.ndarray]:
    """Warm-start state of a separation method as numpy arrays, keyed by its ``__call__`` keywords.

    Reads the raw state (``method._state``) where the method has run: the
    scale restoration after the loop rescales the attributes, and resuming
    from rescaled filters would change the trajectory. A method never run
    gives its declared attributes. Raises ``TypeError`` for a class that
    declares no ``warm_start_keys``.
    """
    keys = getattr(method, "warm_start_keys", None)
    if keys is None:
        raise TypeError(f"{type(method).__name__} declares no warm-start state (warm_start_keys).")
    state = getattr(method, "_state", None)
    if state is not None:
        items = [(name, state[key]) for key, name in keys.items() if key in state]
    else:
        items = [(name, getattr(method, name, None)) for name in keys.values()]
    out = {}
    for name, value in items:
        if value is None:
            continue
        if isinstance(value, (tuple, list)):  # IPSDTA's block-decomposed basis
            for idx, part in enumerate(value):
                out[f"{name}.{idx}"] = _host(part)
        else:
            out[name] = _host(value)
    if getattr(method, "loss", None) is not None:
        out["loss"] = np.asarray(method.loss)
    return out


def save_checkpoint(path: str, method) -> None:
    """Persist a method's warm-start state to ``.npz``."""
    np.savez_compressed(path, **state_dict(method))


def load_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Load a checkpoint into ``__call__``-ready warm-start keywords (the loss history as ``__loss__``)."""
    with np.load(path) as data:
        data = dict(data)
    loss = data.pop("loss", None)

    # reassemble tuple-valued keywords (IPSDTA's basis parts)
    tuples: Dict[str, list] = {}
    for key in [k for k in data if "." in k]:
        name, idx = key.rsplit(".", 1)
        tuples.setdefault(name, []).append((int(idx), data.pop(key)))
    for name, parts in tuples.items():
        data[name] = tuple(v for _, v in sorted(parts))

    if loss is not None:
        data["__loss__"] = loss
    return data


def resume(method, input, path: str, n_iter: int = 100, **kwargs):
    """Continue a run from a checkpoint without duplicating its history.

    Puts the loss history back on ``method`` (where it records one) and
    calls it with the checkpointed state as warm-start keywords and
    ``initial_call=False``. ``output`` goes through only for a demix-free
    state (ISS, IPA: no ``demix_filter`` in the file), with
    ``demix_filter=None``. Keywords the caller passes override the
    checkpoint's.
    """
    state = load_checkpoint(path)
    loss = state.pop("__loss__", None)

    if "demix_filter" in state:
        state.pop("output", None)
    elif "output" in state:
        # a demix-free state: demix_filter=None keeps the warm-started spectrogram
        state["demix_filter"] = None

    if loss is not None and method.record_loss:
        method.loss = [float(v) for v in loss]

    return method(input, n_iter=n_iter, initial_call=False, **{**state, **kwargs})
