"""Regenerate docs/torch/api.md: one line per public symbol of ssspy_tpu_torch, from __all__ + docstrings.

Usage: python docs/torch/gen_api.py > docs/torch/api.md
"""

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

MODULES = [
    "ssspy_tpu_torch", "ssspy_tpu_torch.bss", "ssspy_tpu_torch.bss.base", "ssspy_tpu_torch.bss.ica",
    "ssspy_tpu_torch.bss.fdica", "ssspy_tpu_torch.bss.iva", "ssspy_tpu_torch.bss.ilrma",
    "ssspy_tpu_torch.bss.ipsdta", "ssspy_tpu_torch.bss.mnmf", "ssspy_tpu_torch.bss.cacgmm",
    "ssspy_tpu_torch.bss.proxbss", "ssspy_tpu_torch.bss.pdsbss", "ssspy_tpu_torch.bss.admmbss",
    "ssspy_tpu_torch.bss.hva", "ssspy_tpu_torch.bss._update_spatial_model",
    "ssspy_tpu_torch.linalg", "ssspy_tpu_torch.linalg.prox", "ssspy_tpu_torch.linalg.eig_free",
    "ssspy_tpu_torch.special", "ssspy_tpu_torch.transform", "ssspy_tpu_torch.transform.stft",
    "ssspy_tpu_torch.algorithm", "ssspy_tpu_torch.io", "ssspy_tpu_torch.utils.dataset",
    "ssspy_tpu_torch.utils.select_pair", "ssspy_tpu_torch.utils.flooring", "ssspy_tpu_torch.utils.checkpoint",
    "ssspy_tpu_torch.utils.profiling", "ssspy_tpu_torch.ops.kernels", "ssspy_tpu_torch.parallel",
    "ssspy_tpu_torch.parallel.collectives", "ssspy_tpu_torch.parallel.dryrun", "ssspy_tpu_torch.native",
    "ssspy_tpu_torch.pipeline", "ssspy_tpu_torch.fast",
]


def main():
    print("# API reference of `ssspy_tpu_torch` (public symbols)\n")
    print("Generated by `python docs/torch/gen_api.py`. One line per public symbol;")
    print("see the docstrings for details and the JAX package's `file:line` counterparts.\n")

    for name in MODULES:
        mod = importlib.import_module(name)
        names = getattr(mod, "__all__", None)
        if names is None:
            names = [n for n in vars(mod) if not n.startswith("_")]
            names = [n for n in names if not inspect.ismodule(getattr(mod, n))]
        if not names:
            continue
        print(f"## `{name}`\n")
        for n in sorted(names):
            obj = getattr(mod, n, None)
            if obj is None or inspect.ismodule(obj):
                continue
            doc = (inspect.getdoc(obj) or "").split("\n")[0]
            kind = "class" if inspect.isclass(obj) else ("fn" if callable(obj) else "const")
            print(f"- **{n}** ({kind}) — {doc}")
        print()


if __name__ == "__main__":
    main()
