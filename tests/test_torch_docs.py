"""The port's user docs (``docs/torch``) on the CPU: the API page, every code block, and the walkthrough map.

- ``docs/torch/api.md`` is exactly what ``docs/torch/gen_api.py`` prints.
- Every ```` ```python ```` block of each page runs, the page's blocks in
  order in one namespace, as a reader would run them: with the device the
  blocks name (``"cuda"``) rewritten to ``"cpu"`` (the pages set
  ``DEVICE = "cuda"`` once and pass it on), in a temporary directory.
- ``walkthroughs.md`` names every file of ``docs/walkthroughs/``, and
  ``fast-paths.md`` every ``fast_*`` function of the port.
"""

import contextlib
import importlib.util
import io
import os
import re
import tempfile

import pytest
import torch

import ssspy_tpu_torch.fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs", "torch")
PAGES = ["quickstart.md", "fast-paths.md", "parallelism.md", "migrating-from-ssspy_tpu.md", "walkthroughs.md", "api.md"]

torch.set_num_threads(1)


def _read(name):
    with open(os.path.join(DOCS, name)) as f:
        return f.read()


def _python_blocks(text):
    return re.findall(r"```python\n(.*?)```", text, flags=re.S)


def test_the_pages_and_the_generator_are_there():
    assert sorted(PAGES + ["gen_api.py"]) == sorted(name for name in os.listdir(DOCS) if name != "__pycache__")


def test_api_page_is_the_generators_output():
    spec = importlib.util.spec_from_file_location("torch_docs_gen_api", os.path.join(DOCS, "gen_api.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen.main()
    assert out.getvalue() == _read("api.md")


BLOCK_PAGES = [page for page in PAGES if _python_blocks(_read(page))]


@pytest.mark.parametrize("page", BLOCK_PAGES)
def test_every_code_block_runs_on_the_cpu(monkeypatch, tmp_path, page):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    namespace = {"__name__": f"docs_torch_{page}"}
    blocks = _python_blocks(_read(page))
    assert 'DEVICE = "cuda"' in blocks[0]
    for number, block in enumerate(blocks):
        exec(compile(block.replace('"cuda"', '"cpu"'), f"{page}, block {number}", "exec"), namespace)


def test_the_walkthrough_map_names_every_jax_walkthrough():
    text = _read("walkthroughs.md")
    walkthroughs = sorted(os.listdir(os.path.join(REPO, "docs", "walkthroughs")))
    assert len(walkthroughs) == 35
    missing = [name for name in walkthroughs if f"`{name}`" not in text]
    assert not missing, missing


def test_the_fast_paths_page_lists_every_fast_function():
    text = _read("fast-paths.md")
    missing = [name for name in ssspy_tpu_torch.fast.__all__ if f"`{name}(" not in text]
    assert len(ssspy_tpu_torch.fast.__all__) == 20 and not missing, missing
