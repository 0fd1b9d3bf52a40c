"""The port's example scripts (``examples/torch``) and ``download_sample_speech_data`` against the JAX package's, on the CPU.

- ``utils.dataset.download_sample_speech_data`` equals the JAX function to
  the bit (convolutive and instantaneous mixtures, two seeds), and each
  package reads the other's cache file.
- The class branch of each script against the JAX script's class branch
  (``examples/*.py``, run as its command line gives it with its mixture
  cut: ``torch_examples_helpers.run_jax_script``). Each runs on a 1 s cut
  (the first 16,000 samples) of the script's own mixture, at the script's
  own algorithm, keywords, STFT and iterations, in complex128, and the
  separated waveforms must agree within 1e-9 of their largest magnitude,
  as ``tests/test_torch_flooring.py`` holds the classes. Where they do
  not, the JAX script runs once more on its mixture times (1 + 2.2e-16
  noise), one float64 ulp: where that control moves the JAX output past a
  tenth of 1e-9 the path amplifies rounding (GaussILRMA after ~60
  iterations, AuxLaplaceFDICA), and the port is held within 10 times the
  control's move. cACGMM keeps its own tolerance
  (``torch_examples_helpers.CACGMM_ATOL``, with the reason). Here the
  IVA, ILRMA, FDICA, HVA and fixed-point scripts; the model scripts in
  tests/test_torch_examples_class_models.py and
  tests/test_torch_examples_dense.py (``hold_class_branch``).
- ``batch_mesh`` over 2 gloo ranks on the CPU against one process.
- Every script imports without JAX, and each JAX script has its port.

The complex64 kernel paths against the JAX float32 fast paths are in
tests/test_torch_examples_fast.py, _models.py, _prox.py and _dense.py;
what each branch launches in tests/test_torch_examples_launches.py; each
``main`` in tests/test_torch_examples_main.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ssspy_tpu.utils.dataset import download_sample_speech_data as jax_download
from ssspy_tpu_torch.utils.dataset import download_sample_speech_data

from .torch_examples_helpers import REPO, TORCH_EXAMPLES, cut_mixture, hold_class_branch, load

torch.set_num_threads(1)

SCRIPTS = sorted(f[:-3] for f in os.listdir(TORCH_EXAMPLES) if f.endswith(".py") and not f.startswith("_"))
# ---- download_sample_speech_data -------------------------------------------------------------------------------


@pytest.mark.parametrize("conv", [True, False], ids=["conv", "inst"])
@pytest.mark.parametrize("seed", [0, 42])
def test_download_sample_speech_data_equals_the_jax_function(tmp_path, conv, seed):
    kwargs = dict(n_sources=3, max_duration=0.5, conv=conv, seed=seed)
    images, rate = download_sample_speech_data(cache_dir=str(tmp_path / "port"), **kwargs)
    images_jax, rate_jax = jax_download(cache_dir=str(tmp_path / "jax"), **kwargs)
    assert rate == rate_jax == 16000 and images.dtype == images_jax.dtype
    np.testing.assert_array_equal(images, images_jax)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    # read back from the file: the same arrays again
    np.testing.assert_array_equal(download_sample_speech_data(cache_dir=str(tmp_path / "port"), **kwargs)[0], images)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_cache(tmp_path, writer):
    """One package writes the cache; its file, overwritten with other data under the same name, is what the other reads."""
    kwargs = dict(cache_dir=str(tmp_path), n_sources=2, max_duration=0.25, conv=True, seed=7)
    write, read = (jax_download, download_sample_speech_data) if writer == "jax" else (download_sample_speech_data, jax_download)
    images, _ = write(**kwargs)
    (path,) = [os.path.join(tmp_path, name) for name in os.listdir(tmp_path)]
    np.savez(path, waveform_src_img=images[::-1] * 2, sample_rate=8000)
    got, rate = read(**kwargs)
    assert rate == 8000
    np.testing.assert_array_equal(got, images[::-1] * 2)


# ---- the class branches against the JAX scripts' ------------------------------------------------------------------

# (script, port keywords of run, the JAX script's command line): the IVA, ILRMA, FDICA, HVA and fixed-point
# scripts; the model scripts' in tests/test_torch_examples_class_models.py and tests/test_torch_examples_dense.py
CLASS_BRANCHES = [
    ("separate_auxiva", {}, []),
    ("separate_ilrma", {}, []),
    ("separate_fdica", {}, []),
    ("separate_hva", {}, []),
    ("separate_fixed_point_iva", {"use_class": True}, ["--class"]),
    ("separate_fixed_point_iva", {"use_class": True, "faster": True}, ["--class", "--faster"]),
]


@pytest.mark.parametrize("name, kwargs, argv", CLASS_BRANCHES, ids=[" ".join([n, *a]) for n, _, a in CLASS_BRANCHES])
def test_class_branch_matches_the_jax_script(monkeypatch, tmp_path, name, kwargs, argv):
    hold_class_branch(monkeypatch, tmp_path, name, kwargs, argv)


# ---- batch_mesh over ranks; no JAX ------------------------------------------------------------------------------


def test_batch_mesh_over_two_gloo_ranks_matches_one_process(tmp_path):
    """``batch_mesh.run`` with ``ranks=2`` (layout (1, 2): the 128 bins split over two spawned gloo ranks) against the
    same call in one process with no group, each utterance cut to 0.5 s: float32 sums in another order, within 1e-4
    of the largest magnitude."""
    script = load("batch_mesh")
    mixes = [cut_mixture(tmp_path, cut=8000, **script.MIXTURE, seed=seed)[0] for seed in script.SEEDS]
    y_one = script.run(mixes, device="cpu")
    y_ranks = script.run(mixes, ranks=2, device="cpu")
    assert y_one.shape == y_ranks.shape == (len(mixes), 2, 8000) and np.isfinite(y_ranks).all()
    np.testing.assert_allclose(y_ranks, y_one, rtol=0, atol=1e-4 * np.abs(y_one).max())


def test_examples_import_pulls_in_no_jax():
    """The twin of tests/test_torch_kernels.py's test for the package: every script of examples/torch imports
    without JAX or the JAX package."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {TORCH_EXAMPLES!r})\n"
        f"for name in {SCRIPTS!r}:\n"
        "    __import__(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ssspy_tpu.')) or m == 'ssspy_tpu')\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True, timeout=120)


def test_every_jax_example_has_a_port():
    jax_scripts = sorted(f[:-3] for f in os.listdir(os.path.dirname(TORCH_EXAMPLES))
                         if f.endswith(".py") and not f.startswith("_"))
    assert len(jax_scripts) == 13 and jax_scripts == SCRIPTS
