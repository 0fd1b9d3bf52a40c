"""The frozen mixture equals the program's generator to the bit, and a pool is the same for the same seed."""

import numpy as np
import pytest

from bssbench import mixture


@pytest.mark.parametrize("seed", [0, 2**31 + 17])
def test_frozen_mixture_equals_the_ports_generator(seed):
    from ssspy_tpu_torch.utils.dataset import make_mixture

    np.testing.assert_array_equal(mixture.make_mixture(seed), make_mixture(seed))


def test_pool_is_made_from_the_seed_alone():
    config = {"n_channels": 3, "sample_rate": 16000}
    traffic = {"pool": 2, "recordings_per_call": 2, "recording_seconds": 0.25}
    a, b = mixture.make_pool(7, config, traffic), mixture.make_pool(7, config, traffic, workers=1)
    c = mixture.make_pool(8, config, traffic)
    assert [r.waveforms.shape for r in a] == [(2, 3, 4000)] * 2
    assert all(r.waveforms.dtype == np.float32 and r.audio_seconds == 0.5 for r in a)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x.waveforms, y.waveforms)
        assert x.draw_seed == y.draw_seed != z.draw_seed
        assert not np.array_equal(x.waveforms, z.waveforms)
    assert not np.array_equal(a[0].waveforms[0], a[0].waveforms[1])  # every recording its own seed
