"""Checkpoint files across the packages: a JAX class's file resumed by the port, and a port file by the JAX class.

Each case runs the JAX class ``2k`` iterations uninterrupted and ``k``
iterations into a checkpoint, and the port class ``k`` iterations into
another, in complex128 on the CPU from the same numpy input and seeds.
Each package then resumes the other's file for ``k`` more and must end
within 1e-9 of the JAX class's uninterrupted run (the tolerance of
``tests/test_torch_flooring.py``), its loss history too. The JAX
IPSDTA class takes no ``initial_call`` and records the start's loss on
every call, so its resumed history holds one entry more, the resumed
start's, which is left out of the comparison.

The mixture has 48 frames, so that no eigenvalue of a cACGMM covariance
falls under the E-step's ``eps``: the port floors them there, as the JAX
package's float32 step does (``ops/cacgmm_steps.py``), and the JAX complex
class does not, so below it the two classes part by design (on 16 frames,
two seeds of eight end 3e-3 apart in the loss while their states agree to
1e-14).
"""

import numpy as np
import pytest
import torch

from ssspy_tpu.bss.cacgmm import CACGMM as JaxCACGMM
from ssspy_tpu.bss.ilrma import GaussILRMA as JaxGaussILRMA
from ssspy_tpu.bss.ipsdta import GaussIPSDTA as JaxGaussIPSDTA
from ssspy_tpu.bss.iva import AuxLaplaceIVA as JaxAuxLaplaceIVA
from ssspy_tpu.utils import checkpoint as jax_checkpoint
from ssspy_tpu_torch.bss import CACGMM, AuxLaplaceIVA, GaussILRMA, GaussIPSDTA
from ssspy_tpu_torch.utils import checkpoint, host_stft, make_mixture

torch.set_num_threads(1)

K = 3
TOL = 1e-9


def _seeded(cls, **kwargs):
    return lambda: cls(rng=np.random.default_rng(5), **kwargs)


# name -> (JAX constructor, port constructor)
CASES = {
    "AuxLaplaceIVA-IP1": (lambda: JaxAuxLaplaceIVA(spatial_algorithm="IP1"),
                          lambda: AuxLaplaceIVA(spatial_algorithm="IP1", device="cpu")),
    "AuxLaplaceIVA-ISS1": (lambda: JaxAuxLaplaceIVA(spatial_algorithm="ISS1"),
                           lambda: AuxLaplaceIVA(spatial_algorithm="ISS1", device="cpu")),
    "GaussILRMA-IP": (_seeded(JaxGaussILRMA, n_basis=2, spatial_algorithm="IP"),
                      _seeded(GaussILRMA, n_basis=2, spatial_algorithm="IP", device="cpu")),
    "CACGMM": (_seeded(JaxCACGMM, impl="complex"), _seeded(CACGMM, device="cpu")),
    # 17 bins in 2 blocks: a remainder part, so the basis is a tuple in both packages
    "GaussIPSDTA": (_seeded(JaxGaussIPSDTA, n_basis=2, n_blocks=2, impl="complex"),
                    _seeded(GaussIPSDTA, n_basis=2, n_blocks=2, device="cpu")),
}


def _spectrogram(n_channels=2, n_fft=32, n_frames=48, seed=0):
    n_samples = (n_frames - 1) * (n_fft // 2)
    x = make_mixture(seed=seed, n_channels=n_channels, duration_s=n_samples / 16000)
    return host_stft(x, n_fft=n_fft, hop=n_fft // 2)


def _held(Y, loss, Y_ref, loss_ref):
    np.testing.assert_allclose(Y, Y_ref, atol=TOL * np.abs(Y_ref).max())
    np.testing.assert_allclose(loss, loss_ref, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_files_cross_between_the_packages(name, tmp_path):
    make_jax, make_port = CASES[name]
    X = _spectrogram()
    full = make_jax()
    Y_full = np.asarray(full(X.copy(), n_iter=2 * K))
    loss_full = np.asarray(full.loss)

    jax_half = make_jax()
    jax_half(X.copy(), n_iter=K)
    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_checkpoint(jax_path, jax_half)
    port_half = make_port()
    port_half(torch.from_numpy(X.copy()), n_iter=K)
    port_path = str(tmp_path / "port.npz")
    checkpoint.save_checkpoint(port_path, port_half)
    with np.load(jax_path) as jax_file, np.load(port_path) as port_file:
        assert set(jax_file) == set(port_file)

    # the port resumes the JAX class's file
    port = make_port()
    Y_port = checkpoint.resume(port, torch.from_numpy(X.copy()), jax_path, n_iter=K)
    _held(Y_port.numpy(), port.loss, Y_full, loss_full)

    # the JAX class resumes the port's file
    ref = make_jax()
    Y_ref = np.asarray(jax_checkpoint.resume(ref, X.copy(), port_path, n_iter=K))
    loss_ref = np.asarray(ref.loss)
    if name == "GaussIPSDTA":
        assert len(loss_ref) == len(loss_full) + 1
        loss_ref = np.concatenate([loss_ref[:K + 1], loss_ref[K + 2:]])
    _held(Y_ref, loss_ref, Y_full, loss_full)
