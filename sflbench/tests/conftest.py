"""Shared pieces of the benchmark's tests (run them with ``python -m
pytest sflbench/tests`` from the repository root; the repository's own
suite does not collect them).

Tests marked ``cuda`` need the card and skip without one; the decision
is made inside the test. :func:`tiny_cell` shrinks a cell's widths, depth
and sequence so that a whole run fits on the CPU.
"""
import dataclasses
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import spec  # noqa: E402


def _update(tree: dict, keys: dict):
    for k, v in keys.items():
        if isinstance(v, dict):
            _update(tree[k], v)
        else:
            tree[k] = v


def tiny_cell(cell, seq: int = 32):
    """``cell`` at CPU size: the widths, depth and vocabulary its family's
    ``TINY`` gives for its ``arch_type``, sequence ``seq``; traffic and
    limits as they are."""
    cfg = json.loads(json.dumps(cell.config))
    m = cfg["model"]
    _update(m, spec.family(cfg).tiny[m["arch_type"]])
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, seq=seq))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where there is none")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
