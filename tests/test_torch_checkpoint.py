"""Checkpoint / resume of the port (``ssspy_tpu_torch.utils.checkpoint``) on the CPU.

- The cases of ``tests/utils/test_checkpoint.py`` on the port's classes:
  IP and ISS resume, ILRMA resume, the round-trip keys, the exclusion of
  input-derived keys, and the JAX package's three split-complex cases,
  which here are complex64 runs of the same classes (the port carries
  native complex), equal to the bit.
- Every family: ``k`` iterations, a checkpoint, ``k`` more in a fresh
  instance equal ``2k`` uninterrupted to the bit in complex128, and the
  file holds exactly the keywords the class declares.
- The file is the JAX package's layout: its ``load_checkpoint`` reads a
  port file to the same keys and arrays (the resumes across the packages
  are in ``tests/test_torch_checkpoint_jax.py``).

Mixtures come from the port's own generators, never from a shared cache.
"""

import numpy as np
import pytest
import torch

from ssspy_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from ssspy_tpu_torch.bss import (
    CACGMM,
    AuxGaussIVA,
    AuxIVA,
    AuxLaplaceFDICA,
    AuxLaplaceIVA,
    FastGaussMNMF,
    FastICA,
    FastIVA,
    FasterIVA,
    GaussILRMA,
    GaussIPSDTA,
    GaussMNMF,
    GradGaussIVA,
    NaturalGradLaplaceICA,
)
from ssspy_tpu_torch.bss.base import IterativeMethodBase
from ssspy_tpu_torch.bss.hva import HVA
from ssspy_tpu_torch.bss.iva import ADMMIVA, PDSIVA
from ssspy_tpu_torch.utils import host_stft, make_mixture, sample_speech_mixture
from ssspy_tpu_torch.utils.checkpoint import load_checkpoint, resume, save_checkpoint, state_dict

torch.set_num_threads(1)


def _mixture(n_sources=2, n_samples=4096, seed=0):
    """tests/utils/test_checkpoint.py's mixture: two speech-like sources, convolutive, STFT 256/128, complex128."""
    images, _ = sample_speech_mixture(n_sources=n_sources, max_duration=n_samples / 16000, conv=True, seed=seed)
    return torch.from_numpy(host_stft(images.sum(axis=0), n_fft=256, hop=128))


def _spectrogram(n_channels=3, n_fft=32, n_frames=24, seed=0):
    """Small convolutive mixture STFT: ``(n_channels, n_fft // 2 + 1, n_frames)`` complex128."""
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return torch.from_numpy(host_stft(x, n_fft=n_fft, hop=n_fft // 2))


def contrast_fn(y):
    return 2 * torch.linalg.vector_norm(y, dim=1)


def d_contrast_fn(y):
    return 2 * torch.ones_like(y)


def _auxiva(algo, **kwargs):
    return AuxIVA(spatial_algorithm=algo, contrast_fn=contrast_fn, d_contrast_fn=d_contrast_fn, device="cpu", **kwargs)


def _split_run(make, X, k, path):
    """``k`` iterations, a checkpoint at ``path``, ``k`` more in a fresh instance: ``(resumed, output)``."""
    half = make()
    half(X.clone(), n_iter=k)
    save_checkpoint(path, half)
    cont = make()
    return cont, resume(cont, X.clone(), path, n_iter=k)


# ---- the JAX package's cases ------------------------------------------------------------------------------------


def test_resume_matches_uninterrupted_ip(tmp_path):
    X = _mixture()
    full = _auxiva("IP")
    Y_full = full(X.clone(), n_iter=6)
    half = _auxiva("IP")
    half(X.clone(), n_iter=3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, half)
    cont = _auxiva("IP")
    Y_cont = resume(cont, X.clone(), path, n_iter=3)
    assert torch.equal(Y_cont, Y_full)
    assert len(cont.loss) == len(full.loss) == 7 and cont.loss == full.loss


def test_resume_matches_uninterrupted_iss(tmp_path):
    """Demix-free: the state is the separated spectrogram, passed back with ``demix_filter=None``."""
    X = _mixture()
    full = _auxiva("ISS", scale_restoration=False)
    Y_full = full(X.clone(), n_iter=6)
    half = _auxiva("ISS", scale_restoration=False)
    half(X.clone(), n_iter=3)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, half)
    assert set(load_checkpoint(path)) == {"output", "__loss__"}
    cont = _auxiva("ISS", scale_restoration=False)
    Y_cont = resume(cont, X.clone(), path, n_iter=3)
    assert cont.demix_filter is None
    assert torch.equal(Y_cont, Y_full) and cont.loss == full.loss


def test_resume_ilrma(tmp_path):
    X = _mixture()
    # fresh rng per instance: a shared Generator would be consumed by the first run
    full = GaussILRMA(n_basis=2, spatial_algorithm="IP", rng=np.random.default_rng(0), device="cpu")
    Y_full = full(X.clone(), n_iter=4)
    half = GaussILRMA(n_basis=2, spatial_algorithm="IP", rng=np.random.default_rng(0), device="cpu")
    half(X.clone(), n_iter=2)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, half)
    cont = GaussILRMA(n_basis=2, spatial_algorithm="IP", device="cpu")
    Y_cont = resume(cont, X.clone(), path, n_iter=2)
    assert torch.equal(Y_cont, Y_full) and cont.loss == full.loss


def test_checkpoint_roundtrip_keys(tmp_path):
    X = _mixture()
    ilrma = GaussILRMA(n_basis=2, rng=np.random.default_rng(0), device="cpu")
    ilrma(X, n_iter=1)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, ilrma)
    state = load_checkpoint(path)
    assert set(state) == {"demix_filter", "basis", "activation", "__loss__"}
    for name, key in (("demix_filter", "W"), ("basis", "T"), ("activation", "V")):
        assert isinstance(state[name], np.ndarray) and np.array_equal(state[name], ilrma._state[key].numpy())
    np.testing.assert_array_equal(state["__loss__"], ilrma.loss)


def test_checkpoint_excludes_input_derived_state(tmp_path):
    """Whitened and unit inputs, instant covariances and ADMM's quadratic inverse are recomputed by ``_reset``."""
    X = _mixture()
    fast = FastIVA(contrast_fn=contrast_fn, d_contrast_fn=d_contrast_fn, dd_contrast_fn=torch.zeros_like, device="cpu")
    fast(X.clone(), n_iter=1)
    assert "Xw" in fast._state and set(state_dict(fast)) == {"demix_filter", "loss"}

    mnmf = GaussMNMF(n_basis=2, rng=np.random.default_rng(0), device="cpu")
    mnmf(X.clone(), n_iter=1)
    assert "XX" in mnmf._state and set(state_dict(mnmf)) == {"basis", "activation", "spatial", "loss"}

    # the Z of these two is the input's: no latent, no bogus warm-start keyword
    gmm = CACGMM(rng=np.random.default_rng(0), device="cpu")
    gmm(X.clone(), n_iter=1)
    assert "Z" in gmm._state and set(state_dict(gmm)) == {"mixing", "covariance", "loss"}
    x = torch.from_numpy(make_mixture(seed=1, n_channels=2, duration_s=0.05))
    ica = FastICA(contrast_fn=lambda y: torch.log(torch.cosh(y)), score_fn=torch.tanh,
                  d_score_fn=lambda y: 1 - torch.tanh(y) ** 2, device="cpu")
    ica(x, n_iter=1)
    assert "Z" in ica._state and set(state_dict(ica)) == {"demix_filter", "loss"}

    admm = ADMMIVA(device="cpu")
    admm(X.clone(), n_iter=1)
    assert "quad_inv" in admm._state
    assert set(state_dict(admm)) == {"demix_filter", "auxiliary1", "auxiliary2", "dual1", "dual2", "loss"}


def test_complex64_checkpoint_resume_matches_uninterrupted(tmp_path):
    """The JAX package's split-complex IP1 case, as a complex64 run: the file holds complex filters."""
    X = _mixture().to(torch.complex64)
    full = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")
    Y_full = full(X.clone(), n_iter=8)
    half = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")
    half(X.clone(), n_iter=4)
    path = str(tmp_path / "c64.npz")
    save_checkpoint(path, half)
    state = load_checkpoint(path)
    assert set(state) == {"demix_filter"} and state["demix_filter"].dtype == np.complex64
    rest = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")
    assert torch.equal(resume(rest, X.clone(), path, n_iter=4), Y_full)


def test_complex64_checkpoint_demix_free(tmp_path):
    X = _mixture().to(torch.complex64)
    full = AuxLaplaceIVA(spatial_algorithm="ISS1", record_loss=False, device="cpu")
    Y_full = full(X.clone(), n_iter=8)
    half = AuxLaplaceIVA(spatial_algorithm="ISS1", record_loss=False, device="cpu")
    half(X.clone(), n_iter=4)
    path = str(tmp_path / "c64_iss.npz")
    save_checkpoint(path, half)
    state = load_checkpoint(path)
    assert set(state) == {"output"} and state["output"].dtype == np.complex64
    rest = AuxLaplaceIVA(spatial_algorithm="ISS1", record_loss=False, device="cpu")
    assert torch.equal(resume(rest, X.clone(), path, n_iter=4), Y_full)


def test_complex64_checkpoint_cacgmm(tmp_path):
    """cACGMM keeps its mixing weights (real) and covariances (complex) and not its unit input."""
    X = _mixture().to(torch.complex64)

    def make(seed):
        return CACGMM(rng=np.random.default_rng(seed), permutation_alignment=False, record_loss=False, device="cpu")

    Y_full = make(2)(X.clone(), n_iter=8)
    half = make(2)
    half(X.clone(), n_iter=4)
    path = str(tmp_path / "c64_cacgmm.npz")
    save_checkpoint(path, half)
    state = load_checkpoint(path)
    assert set(state) == {"mixing", "covariance"}
    assert state["covariance"].dtype == np.complex64 and state["mixing"].dtype == np.float32
    assert torch.equal(resume(make(99), X.clone(), path, n_iter=4), Y_full)


# ---- every family: k + k iterations are 2k, to the bit -------------------------------------------------------------


def _laplace_ica():
    return NaturalGradLaplaceICA(device="cpu")


def _fast_ica():
    return FastICA(contrast_fn=lambda y: torch.log(torch.cosh(y)), score_fn=torch.tanh,
                   d_score_fn=lambda y: 1 - torch.tanh(y) ** 2, device="cpu")


def _seeded(cls, **kwargs):
    return lambda: cls(rng=np.random.default_rng(0), device="cpu", **kwargs)


# name -> (constructor, waveform input, k, the keywords the file holds besides the loss)
FAMILIES = {
    **{
        f"AuxLaplaceIVA-{algo}": (lambda algo=algo: AuxLaplaceIVA(spatial_algorithm=algo, device="cpu"), False, k,
                                  {"demix_filter"} if algo.startswith("IP") and algo != "IPA" else {"output"})
        for algo, k in (("IP1", 50), ("IP2", 20), ("ISS1", 50), ("ISS2", 20), ("IPA", 10))
    },
    "AuxGaussIVA-IP1": (lambda: AuxGaussIVA(spatial_algorithm="IP1", device="cpu"), False, 50,
                        {"demix_filter", "variance"}),
    "GradGaussIVA": (lambda: GradGaussIVA(device="cpu"), False, 50, {"demix_filter", "variance"}),
    "GaussILRMA-IP1": (_seeded(GaussILRMA, n_basis=2, spatial_algorithm="IP1"), False, 50,
                       {"demix_filter", "basis", "activation"}),
    "GaussILRMA-ISS1, partitioning": (_seeded(GaussILRMA, n_basis=2, spatial_algorithm="ISS1", partitioning=True),
                                      False, 50, {"output", "basis", "activation", "latent"}),
    "GaussMNMF": (_seeded(GaussMNMF, n_basis=2), False, 10, {"basis", "activation", "spatial"}),
    "GaussMNMF, partitioning": (_seeded(GaussMNMF, n_basis=2, partitioning=True), False, 10,
                                {"basis", "activation", "spatial", "latent"}),
    "FastGaussMNMF": (_seeded(FastGaussMNMF, n_basis=2), False, 10, {"basis", "activation", "diagonalizer", "spatial"}),
    "GaussIPSDTA": (_seeded(GaussIPSDTA, n_basis=2, n_blocks=2), False, 5, {"demix_filter", "basis.0", "basis.1",
                                                                            "activation"}),
    "CACGMM": (_seeded(CACGMM), False, 25, {"mixing", "covariance"}),
    "FastIVA": (lambda: FastIVA(contrast_fn=contrast_fn, d_contrast_fn=d_contrast_fn, dd_contrast_fn=torch.zeros_like,
                                device="cpu"), False, 20, {"demix_filter"}),
    "FasterIVA": (lambda: FasterIVA(contrast_fn=contrast_fn, d_contrast_fn=d_contrast_fn, device="cpu"), False, 20,
                  {"demix_filter"}),
    "AuxLaplaceFDICA-IP1": (lambda: AuxLaplaceFDICA(spatial_algorithm="IP1", device="cpu"), False, 20,
                            {"demix_filter"}),
    "PDSIVA": (lambda: PDSIVA(device="cpu"), False, 20, {"demix_filter", "dual"}),
    "HVA": (lambda: HVA(device="cpu"), False, 10, {"demix_filter", "dual"}),  # no penalty_fn: no loss
    "ADMMIVA": (lambda: ADMMIVA(device="cpu"), False, 20,
                {"demix_filter", "auxiliary1", "auxiliary2", "dual1", "dual2"}),
    "NaturalGradLaplaceICA": (_laplace_ica, True, 50, {"demix_filter"}),
    "FastICA": (_fast_ica, True, 20, {"demix_filter"}),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_k_plus_k_iterations_are_2k_to_the_bit(name, tmp_path):
    make, waveform, k, keys = FAMILIES[name]
    if waveform:
        X = torch.from_numpy(make_mixture(seed=0, n_channels=2, duration_s=0.05))
    else:
        X = _spectrogram()
    full = make()
    Y_full = full(X.clone(), n_iter=2 * k)
    path = str(tmp_path / "state.npz")
    cont, Y_cont = _split_run(make, X, k, path)
    with np.load(path) as data:
        assert set(data) == keys | ({"loss"} if full.record_loss else set())
    assert torch.equal(Y_cont, Y_full)
    if full.record_loss:
        assert len(cont.loss) == 2 * k + 1 and cont.loss == full.loss


# ---- the declaration, the fallback and the layout -------------------------------------------------------------------


def test_a_class_that_declares_nothing_cannot_be_checkpointed():
    class Bare(IterativeMethodBase):
        pass

    with pytest.raises(TypeError, match="declares no warm-start state"):
        state_dict(Bare(device="cpu"))


def test_a_method_never_run_gives_its_declared_attributes():
    """Without ``_state``, the attributes the declaration names; a tuple basis as its parts."""
    iva = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")
    W = torch.eye(2, dtype=torch.complex128).expand(5, 2, 2)
    iva.demix_filter = W
    assert set(state_dict(iva)) == {"demix_filter"} and np.array_equal(state_dict(iva)["demix_filter"], W.numpy())
    ipsdta = GaussIPSDTA(n_basis=2, n_blocks=2, device="cpu")
    ipsdta.basis, ipsdta.activation = (torch.ones(2, 2, 1, 4, 4), torch.ones(2, 2, 1, 5, 5)), torch.ones(2, 2, 7)
    assert set(state_dict(ipsdta)) == {"basis.0", "basis.1", "activation", "loss"}


def test_a_port_file_reads_the_same_in_the_jax_package(tmp_path):
    X = _spectrogram(n_channels=2)
    ipsdta = GaussIPSDTA(n_basis=2, n_blocks=2, rng=np.random.default_rng(0), device="cpu")
    ipsdta(X, n_iter=2)
    path = str(tmp_path / "ipsdta.npz")
    save_checkpoint(path, ipsdta)
    got, ref = load_checkpoint(path), jax_load_checkpoint(path)
    assert set(got) == set(ref) == {"demix_filter", "basis", "activation", "__loss__"}
    assert isinstance(ref["basis"], tuple) and len(ref["basis"]) == 2
    for name in got:
        for a, b in zip(*(v if isinstance(v, tuple) else (v,) for v in (got[name], ref[name]))):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_resume_keywords_override_the_checkpoint(tmp_path):
    """A keyword the caller passes wins over the file's: a fresh identity start reproduces a fresh run."""
    X = _spectrogram(n_channels=2)
    half = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")
    half(X.clone(), n_iter=3)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, half)
    eye = torch.eye(2, dtype=X.dtype).expand(X.shape[1], 2, 2).contiguous()
    Y = resume(AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu"), X.clone(), path, n_iter=3,
               demix_filter=eye)
    Y_fresh = AuxLaplaceIVA(spatial_algorithm="IP1", record_loss=False, device="cpu")(X.clone(), n_iter=3)
    assert torch.equal(Y, Y_fresh)
