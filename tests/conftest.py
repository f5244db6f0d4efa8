"""Suite-wide configuration: the ``slow`` marker and the ``--fast`` toggle.

The full suite trains several tiny models with QAT and takes >5 min on CPU.
``pytest --fast`` (or ``REPRO_FAST=1``) skips everything marked
``@pytest.mark.slow`` so tier-1 verification stays quick:

    PYTHONPATH=src python -m pytest -q --fast
"""

from __future__ import annotations

import os
import sys

import pytest

# make `from _hypothesis_compat import ...` work regardless of rootdir layout
sys.path.insert(0, os.path.dirname(__file__))


def pytest_addoption(parser):
    parser.addoption(
        "--fast",
        action="store_true",
        default=False,
        help="skip tests marked slow (QAT training, long property sweeps)",
    )


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: takes >10s on CPU (training loops, big sweeps)"
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)"
    )


def pytest_collection_modifyitems(config, items):
    fast = config.getoption("--fast") or os.environ.get("REPRO_FAST", "") not in (
        "",
        "0",
    )
    if not fast:
        return
    skip = pytest.mark.skip(reason="skipped by --fast / REPRO_FAST=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
