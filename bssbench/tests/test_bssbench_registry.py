"""A configuration, a traffic mix, an entry adapter and a per-layer metric, each a new file, are taken by name."""

import json
import shutil
from pathlib import Path

from bssbench import harness
from conftest import ROOT

NEW_ENTRY = '''"""An entry a later change might add: the port's waveform AuxIVA, by its own name."""

import torch


def make(config, device):
    from ssspy_tpu_torch.fast import fast_auxiva_wave

    def call(request):
        return fast_auxiva_wave(torch.from_numpy(request.waveforms), n_iter=config["n_iter"], device=device)

    return call
'''

NEW_METRIC = '''"""A per-layer metric a later change might add: the calls the trace holds."""


def read(trace, ctx):
    return float(len(trace.calls))
'''


def test_new_files_are_found_by_name_without_an_edit(tmp_path: Path):
    shutil.copytree(Path(ROOT) / "bssbench", tmp_path / "bssbench", ignore=shutil.ignore_patterns("__pycache__"))
    home = tmp_path / "bssbench"
    config = json.loads((home / "configs" / "auxiva_ip1_8ch.json").read_text())
    config.update(name="tiny_iva", n_channels=3, n_sources=3, n_iter=5, entries={"single": "tiny_entry"})
    (home / "configs" / "tiny_iva.json").write_text(json.dumps(config))
    (home / "traffic" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "recording_seconds": 0.25, "recordings_per_call": 1, "pool": 2, "loop": "closed",
         "callers": 1, "compare_calls": 1}))
    (home / "entries" / "tiny_entry.py").write_text(NEW_ENTRY)
    (home / "metrics" / "calls_traced.py").write_text(NEW_METRIC)
    (home / "limits" / "tiny_iva.tiny.json").write_text(json.dumps(
        {harness.GAP_P90: {"limit": 1e-3}, harness.BINS_OVER: {"gap": 0.01, "limit": 4}}))
    bench = json.loads((Path(ROOT) / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_iva", "source": "a test", "file": "bssbench/configs/tiny_iva.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_iva.tiny", "config": "tiny_iva", "traffic": "tiny", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls", "better": "higher", "source": "device_trace",
                               "layer": "Device", "moves": "audio_rate", "workloads": ["tiny_iva.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.Cell(tmp_path, "tiny_iva.tiny")
    assert cell.entry_name == "tiny_entry" and cell.traffic["recording_seconds"] == 0.25
    assert "calls_traced" in [m["name"] for m in cell.per_layer]
    assert "k1_roofline" not in [m["name"] for m in cell.per_layer]  # listed for other cells only
    result, _, _ = harness.run(cell, 9, 0.2, True, "cpu")
    assert result["correct"] is True
    assert result["metrics"]["calls_traced"] == {"value": float(harness.N_TRACED), "unit": "calls"}
    result, _, _ = harness.run(cell, 9, 0.2, False, "cpu")
    assert set(result["metrics"]) == {"setup_s", "audio_rate", "latency_p95"}
