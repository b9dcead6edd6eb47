"""One torch thread for the port's CPU test files.

The suite runs under pytest-xdist, several worker processes on the
machine's cores.  Each worker's torch starts one intra-op thread a core, so
together they oversubscribe the CPU, and a model that issues a few hundred
small ops spends its time waiting on its own threads: a P = 128 tile-walk
model of the secure-aggregation kernels takes 0.03 s in one process and
22-25 s in each of six at once.  A test file imports `one_torch_thread`
(autouse, module-scoped): torch runs on one thread while the file's tests
run, and the worker's old count comes back for the next file.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
