#!/usr/bin/env python3
"""Run the port's classes and fast paths with max-type floors on the CPU, save their outputs, and compare two trees to the bit.

A ``flooring_fn`` that floors with ``max(., eps)`` must keep its routes and
its bits whatever the steps do with other callables. ``save`` imports
``ssspy_tpu_torch`` from ``--root`` (the repository root by default, or an
unpacked copy of another commit) and runs, on a 3-channel mixture (17 bins
x 24 frames) for 3 iterations, every class that takes ``flooring_fn`` and
the fast paths of those families: complex128 with ``"dtype"`` and with a
``max_flooring`` partial at 1e-4, complex64 with ``"dtype"``; outputs and
losses go to one ``.npz``. ``compare`` holds two such files equal to the
bit::

    git archive <parent> | tar -x -C _tree/parent
    python3 scripts/torch_flooring_bits.py save _tree/parent.npz --root _tree/parent
    python3 scripts/torch_flooring_bits.py save _tree/change.npz
    python3 scripts/torch_flooring_bits.py compare _tree/parent.npz _tree/change.npz

Imports torch and numpy, never JAX. Takes about a minute on 2 CPU threads.
"""

import argparse
import functools
import os
import sys


def save(path: str, root: str) -> None:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from ssspy_tpu_torch import bss, fast
    from ssspy_tpu_torch.special import max_flooring
    from ssspy_tpu_torch.utils import host_stft, make_mixture

    torch.set_num_threads(2)
    n_fft, n_frames = 32, 24
    x = make_mixture(seed=3, n_channels=3, duration_s=(n_frames - 1) * (n_fft // 2) / 16000)
    X128 = host_stft(x, n_fft=n_fft, hop=n_fft // 2)

    def seeded(seed):
        return {"rng": np.random.default_rng(seed)}

    out = {}
    for dtype, tag in ((np.complex128, "c128"), (np.complex64, "c64")):
        X = torch.from_numpy(X128.astype(dtype))
        floors = ["dtype", functools.partial(max_flooring, eps=1e-4)] if dtype == np.complex128 else ["dtype"]
        for k, ff in enumerate(floors):
            classes = {}
            for a in ("IP1", "IP2", "ISS1", "ISS2", "IPA"):
                classes[f"AuxLaplaceIVA-{a}"] = bss.AuxLaplaceIVA(spatial_algorithm=a, flooring_fn=ff, device="cpu")
                classes[f"GaussILRMA-{a}"] = bss.GaussILRMA(
                    n_basis=2, spatial_algorithm=a, flooring_fn=ff, device="cpu", **seeded(1))
            for a in ("IP1", "ISS1"):
                classes[f"AuxGaussIVA-{a}"] = bss.AuxGaussIVA(spatial_algorithm=a, flooring_fn=ff, device="cpu")
                classes[f"TILRMA-{a}"] = bss.TILRMA(
                    n_basis=2, dof=100, spatial_algorithm=a, flooring_fn=ff, device="cpu", **seeded(1))
                classes[f"GGDILRMA-{a}"] = bss.GGDILRMA(
                    n_basis=2, beta=1.5, spatial_algorithm=a, flooring_fn=ff, device="cpu", **seeded(1))
            for a in ("IP1", "IP2"):
                classes[f"AuxLaplaceFDICA-{a}"] = bss.AuxLaplaceFDICA(spatial_algorithm=a, flooring_fn=ff, device="cpu")
                classes[f"FastGaussMNMF-{a}"] = bss.FastGaussMNMF(
                    n_basis=2, diagonalizer_algorithm=a, flooring_fn=ff, device="cpu", **seeded(2))
            classes["GaussMNMF"] = bss.GaussMNMF(n_basis=2, flooring_fn=ff, device="cpu", **seeded(2))
            classes["GaussMNMF-partitioning"] = bss.GaussMNMF(
                n_basis=2, partitioning=True, flooring_fn=ff, device="cpu", **seeded(2))
            classes["GaussIPSDTA"] = bss.GaussIPSDTA(n_basis=2, n_blocks=2, flooring_fn=ff, device="cpu", **seeded(3))
            classes["TIPSDTA"] = bss.TIPSDTA(n_basis=2, n_blocks=2, dof=100, flooring_fn=ff, device="cpu", **seeded(3))
            classes["CACGMM"] = bss.CACGMM(flooring_fn=ff, device="cpu", **seeded(4))
            classes["CACGMM-chol"] = bss.CACGMM(flooring_fn=ff, impl="chol", device="cpu", **seeded(4))
            for name, method in classes.items():
                out[f"{tag}/{k}/{name}"] = method(X.clone(), n_iter=3).numpy()
                out[f"{tag}/{k}/{name}/loss"] = np.asarray(method.loss)
        Xn = X128.astype(dtype)
        paths = {
            **{f"fast_auxiva-{a}": (fast.fast_auxiva, {"algorithm": a}) for a in ("IP1", "ISS2", "IPA")},
            "fast_gauss_ilrma": (fast.fast_gauss_ilrma, {"n_basis": 2, **seeded(9)}),
            "fast_gauss_mnmf": (fast.fast_gauss_mnmf, {"n_basis": 2, **seeded(9)}),
            "fast_gauss_mnmf_dense": (fast.fast_gauss_mnmf_dense, {"n_basis": 2, **seeded(9)}),
            "fast_cacgmm": (fast.fast_cacgmm, seeded(9)),
            "fast_gauss_ipsdta": (fast.fast_gauss_ipsdta, {"n_basis": 2, "n_blocks": 2, **seeded(9)}),
            "fast_t_ipsdta": (fast.fast_t_ipsdta, {"n_basis": 2, "n_blocks": 2, "dof": 100, **seeded(9)}),
            "fast_aux_fdica": (fast.fast_aux_fdica, {}),
        }
        for name, (fn, kw) in paths.items():
            result = fn(Xn, n_iter=3, device="cpu", **kw)
            for j, part in enumerate(result if isinstance(result, tuple) else (result,)):
                if isinstance(part, torch.Tensor):
                    out[f"{tag}/fast/{name}/{j}"] = part.numpy()
    np.savez(path, **out)
    print(f"{len(out)} arrays from {os.path.dirname(bss.__file__)} -> {path}")


def compare(a_path: str, b_path: str) -> int:
    import numpy as np

    a, b = np.load(a_path), np.load(b_path)
    if set(a.files) != set(b.files):
        print("the files hold other arrays:", sorted(set(a.files) ^ set(b.files)))
        return 1
    differ = [k for k in a.files if a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes()]
    print(f"{len(a.files)} arrays compared; " + ("all bit-equal" if not differ else f"{len(differ)} differ: {differ}"))
    return 1 if differ else 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    p_save = sub.add_parser("save")
    p_save.add_argument("path")
    p_save.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p_compare = sub.add_parser("compare")
    p_compare.add_argument("a")
    p_compare.add_argument("b")
    args = parser.parse_args()
    if args.command == "save":
        save(args.path, args.root)
        return 0
    return compare(args.a, args.b)


if __name__ == "__main__":
    sys.exit(main())
