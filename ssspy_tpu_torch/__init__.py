"""ssspy_tpu_torch: blind source separation on PyTorch, with CUDA kernels for Hopper.

The PyTorch counterpart of :mod:`ssspy_tpu`, carried slice by slice
(ROADMAP.md). It imports torch and numpy, never JAX. Tensors are native
complex (complex64 on the card); the hot-path kernels are written by hand
in CUDA C++ for ``sm_90a`` (``ops/csrc``), built with ``nvcc`` on first
use, and each has a plain PyTorch version that CPU tensors take.

Ported so far: time-domain ICA (the gradient, natural-gradient and
fixed-point classes); FDICA (the gradient, natural-gradient and
auxiliary-function classes with IP1 and IP2, :func:`fast.fast_aux_fdica`,
:func:`fast.fast_grad_fdica`); AuxIVA and AuxGaussIVA with IP1, IP2, ISS1, ISS2 and
IPA (class API and :func:`fast.fast_auxiva`); the gradient and fixed-point
IVA classes (:func:`fast.fast_grad_iva`, :func:`fast.fast_fast_iva`,
:func:`fast.fast_faster_iva`); Gauss, t and GGD ILRMA with IP1, IP2, ISS1
and ISS2 (class API and :func:`fast.fast_gauss_ilrma`,
:func:`fast.fast_t_ilrma`, :func:`fast.fast_ggd_ilrma`); the proximal-splitting family PDSIVA,
HVA and ADMMIVA (class API, the PDS/ADMM base classes and
:func:`fast.fast_pds_iva`, :func:`fast.fast_hva`,
:func:`fast.fast_admm_iva`); dense GaussMNMF (class API and
:func:`fast.fast_gauss_mnmf_dense`); IPSDTA (class API and
:func:`fast.fast_gauss_ipsdta`, :func:`fast.fast_t_ipsdta`); FastGaussMNMF
with the IP1 and IP2 diagonalizers (class API and
:func:`fast.fast_gauss_mnmf`); cACGMM (class API and
:func:`fast.fast_cacgmm`) with the permutation solvers; STFT/iSTFT,
PCA and whitening, projection back, minimal distortion principle, the eigendecomposition-free
routes of :mod:`linalg.eig_free` (options of the IPA, FastIVA and FasterIVA
steps), the waveform-to-waveform
:func:`separate`, :func:`fast.fast_auxiva_wave` and
:func:`fast.fast_gauss_ilrma_wave`; the (dp, bin) multi-device runners
(:mod:`parallel`); WAV I/O (:func:`wavread`, :func:`wavwrite`) and the
native codec (:mod:`native`); the reference's public math helpers
(:mod:`linalg`, :mod:`special`) and spatial updates (``update_by_*``). Every
entry point runs on the card unless the caller passes ``device="cpu"``.
"""

from . import algorithm, bss, fast, linalg, native, ops, parallel, special, transform, utils
from .io import wavread, wavwrite
from .pipeline import separate

__version__ = "0.1.0"

__all__ = [
    "wavread",
    "wavwrite",
    "algorithm",
    "bss",
    "fast",
    "linalg",
    "native",
    "ops",
    "parallel",
    "special",
    "transform",
    "utils",
    "separate",
]
