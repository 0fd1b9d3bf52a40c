"""``run.py`` without a card, in a bare checkout, and what a run loads."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "ssspy_tpu"}


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "bssbench/run.py", "--workload", "auxiva_ip1_8ch.batch16_10s", "--seed",
                           "2147483659", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 2
    assert "needs 1 CUDA card" in proc.stderr and "No result" in proc.stderr
    assert proc.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_gives_no_result(tmp_path: Path):
    shutil.copytree(Path(ROOT) / "bssbench", tmp_path / "bssbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(Path(ROOT) / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from bssbench import harness; "
            "cell = harness.Cell('.', 'auxiva_ip1_8ch.single_60s'); harness.run(cell, 1, 0.1, False, 'cpu')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "ssspy_tpu_torch" in proc.stderr
    assert proc.stdout.strip() == ""


def _modules_after(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return {name.split(".")[0] for name in json.loads(proc.stdout.strip().splitlines()[-1])}


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_port():
    run_code = """
import sys
sys.path.insert(0, '.')
from bssbench import harness
for w in ('auxiva_ip1_8ch.batch16_10s', 'gauss_ilrma_ip1_8ch.single_60s', 'auxiva_ip1_8ch.single_60s'):
    cell = harness.Cell('.', w)
    cell.config.update(n_channels=3, n_sources=3, n_iter=3)
    cell.traffic.update(recording_seconds=0.25, recordings_per_call=min(2, cell.traffic['recordings_per_call']), pool=1)
    harness.run(cell, 4, 0.05, True, 'cpu')
    [cell.reader(m['name']) for m in cell.per_layer]
assert not harness.forbidden_modules()
"""
    loaded = _modules_after(run_code)
    assert "ssspy_tpu_torch" in loaded and not loaded & FORBIDDEN
    reference_code = """
import sys
sys.path.insert(0, '.')
import json
import numpy as np
from bssbench.reference import auxiva_ip1, gauss_ilrma_ip1
config = json.load(open('bssbench/configs/gauss_ilrma_ip1_8ch.json'))
config.update(n_iter=2)
x = np.random.default_rng(0).standard_normal((8, 4000))
auxiva_ip1.separate(x, config, 0, 'cpu')
gauss_ilrma_ip1.separate(x, config, 0, 'cpu')
"""
    loaded = _modules_after(reference_code)
    assert "torch" in loaded and not loaded & (FORBIDDEN | {"ssspy_tpu_torch"})
