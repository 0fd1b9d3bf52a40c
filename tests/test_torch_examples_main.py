"""Each example script's ``main`` (examples/torch) from its command line on the CPU, and the WAVs it writes.

Each script's ``main`` runs its default branch with ``--device cpu`` and
``--out`` on a 0.25 s cut of its mixture (``make_mixture`` patched in the
script's namespace; the launches follow the iterations, not the length), down the card's branch on the CPU (each kernel wrapper
its checks, a count and its plain version, ``torch_examples_helpers.counting``):
it launches exactly what ``chip_smoke.py``'s ``EXAMPLE_RUNS`` says of the
default branch (the other branches: tests/test_torch_examples_launches.py),
prints the report's SI-SDR line, and its WAVs read back with ``wavread``:
one per source, each of the cut's length (``batch_mesh`` and
``separate_f32_mode`` write none, as their JAX scripts).
"""

import os

import numpy as np
import pytest
import torch

from ssspy_tpu_torch import wavread

from .torch_examples_helpers import TORCH_EXAMPLES, common, counting, example_runs, load

torch.set_num_threads(1)

SCRIPTS = sorted(f[:-3] for f in os.listdir(TORCH_EXAMPLES) if f.endswith(".py") and not f.startswith("_"))
DEFAULT_USES = {name: uses for name, kwargs, uses in example_runs() if not kwargs}
SHORT = 4_000  # a quarter second


@pytest.mark.parametrize("name", SCRIPTS)
def test_main_runs_on_the_cpu_and_writes_its_wavs(monkeypatch, tmp_path, capsys, name):
    script, make_mixture = load(name), common().make_mixture

    def cut(**kwargs):
        mix, images = make_mixture(cache_dir=str(tmp_path), **kwargs)
        return mix[:, :SHORT], images[..., :SHORT]

    monkeypatch.setattr(script, "make_mixture", cut, raising=False)
    monkeypatch.setattr(common(), "make_mixture", cut)  # batch_mesh imports it inside main
    counts = counting(monkeypatch)
    out = tmp_path / "out"
    script.main(["--device", "cpu", "--out", str(out)])
    assert {k: v for k, v in counts.items() if v} == DEFAULT_USES[name]
    assert "SI-SDR: mixture" in capsys.readouterr().out
    wavs = sorted(out.iterdir()) if out.exists() else []
    if name in ("batch_mesh", "separate_f32_mode"):
        assert not wavs
        return
    assert len(wavs) == script.MIXTURE["n_sources"]
    for path in wavs:
        data, rate = wavread(str(path))
        assert rate == 16000 and data.shape == (SHORT,) and np.abs(data).max() > 0.5
