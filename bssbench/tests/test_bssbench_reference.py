"""The plain references agree with the port's CPU path, and the control's TF32 rounding is what it says."""

import json
import os

import numpy as np
import pytest
import torch

from bssbench import harness, mixture
from bssbench.reference import auxiva_ip1, gauss_ilrma_ip1
from bssbench.reference.common import tf32_round

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_config(name: str) -> dict:
    with open(os.path.join(HOME, "configs", f"{name}.json")) as f:
        config = json.load(f)
    config.update(n_channels=4, n_sources=4, n_iter=20)
    return config


def test_reference_meets_the_ports_waveform_entries_in_complex64():
    """20 iterations on 1 s of 4 channels: the port's float32 path within 1e-4 of the complex128 reference, and TF32
    products (the control) far outside it, beyond 1e-2."""
    from ssspy_tpu_torch.fast import fast_auxiva_wave, fast_gauss_ilrma_wave

    x = mixture.make_mixture(4, n_channels=4, duration_s=1.0).astype(np.float32)
    config = small_config("auxiva_ip1_8ch")
    y = fast_auxiva_wave(x, n_iter=config["n_iter"], device="cpu")
    ref = auxiva_ip1.separate(x, config, 0, "cpu")
    assert harness.rel_err(y, ref) < 1e-4 < 1e-2 < harness.rel_err(auxiva_ip1.separate(x, config, 0, "cpu", "tf32"), ref)
    config = small_config("gauss_ilrma_ip1_8ch")
    y = fast_gauss_ilrma_wave(x, n_basis=config["n_basis"], n_iter=config["n_iter"], rng=np.random.default_rng(5), device="cpu")
    ref = gauss_ilrma_ip1.separate(x, config, 5, "cpu")
    assert harness.rel_err(y, ref) < 1e-4 < 1e-2 < harness.rel_err(gauss_ilrma_ip1.separate(x, config, 5, "cpu", "tf32"), ref)


def test_a_batch_is_its_utterances():
    config = small_config("auxiva_ip1_8ch")
    x = np.stack([mixture.make_mixture(s, n_channels=4, duration_s=0.5) for s in (1, 2, 3)])
    batch = auxiva_ip1.separate(x, config, 0, "cpu", block=2)
    for b in range(3):
        torch.testing.assert_close(batch[b], auxiva_ip1.separate(x[b], config, 0, "cpu"), rtol=1e-12, atol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 0.0])
    # 10 mantissa bits: 1 + 2^-11 is a tie and rounds to even (1); 1 + 3 * 2^-11 rounds up to 1 + 2^-9
    expected = torch.tensor([1.0, 1.0, 1.0 + 2**-9, 1.0 + 2**-10, -3.0, 0.0])
    assert torch.equal(tf32_round(x), expected)
    z = torch.complex(x, -x)
    assert torch.equal(tf32_round(z.conj()), torch.complex(expected, expected))
