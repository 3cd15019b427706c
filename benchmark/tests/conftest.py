"""Shared fixtures of the benchmark's CPU tests: the harness's folder on
``sys.path`` and a throwaway checkout with the cells cut to a size the CPU
runs in a second."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CHUNK = {"frames": 8, "height": 64, "width": 128}


@pytest.fixture(scope="session", autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tiny_root(dest: Path) -> Path:
    """A copy of the benchmark in ``dest`` whose configurations code
    8x64x128 chunks with 16-row segments."""
    shutil.copytree(BENCH, dest / "benchmark", ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["chunk"] = dict(TINY_CHUNK)
        cfg["codec"]["s_seg"] = 16
        path.write_text(json.dumps(cfg))
    for t in (dest / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(t.read_text())
        if "region" in mix["content"]:
            mix["content"]["region"]["size"] = 32
        t.write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
