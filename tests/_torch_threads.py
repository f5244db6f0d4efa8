"""One intra-op thread for the port's CPU tests.

The suite runs as several pytest workers at once, and each starts torch
with one OpenMP thread per core; workers whose threads spin at every
parallel region's barrier while other processes hold the cores slow one
another many times over (a Table 6 run took ~20x its solo time). Each
``test_torch_*`` module that runs torch imports ``one_torch_thread``,
which holds torch at one thread while the module's tests and fixtures
run and restores the count after; child processes get
``OMP_NUM_THREADS=1`` in their environment.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
