"""The benchmark's CPU tests: `python -m pytest portbench/tests -q` from
the repository's root. Tests that need an NVIDIA GPU carry the `cuda`
marker (registered in pyproject.toml) and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"


def tiny_cell(name: str, **config):
    """The cell `name` of the repository's BENCHMARK.json at a size the
    CPU renders in about a second."""
    from portbench import harness
    cell = harness.find_cell(harness.load_spec(), name)
    cell["config"].update(nx=24, ny=16, spp=6, max_depth=5, **config)
    cell["config"]["check"] = dict(cell["config"]["check"], tiles=2)
    cell["traffic"] = dict(cell["traffic"], samples_per_launch=4,
                           warmup_seconds=0.0)
    return cell
