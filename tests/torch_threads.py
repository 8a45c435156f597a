"""One torch CPU thread for a test module's duration: an autouse fixture to import.

The tier-1 run puts several pytest workers on one machine. Each worker's
torch would start as many intra-op threads as the machine has cores, and
the workers' threads would then wait on one another. A test module that
imports ``one_torch_thread`` runs its torch work on one thread and
restores the count after. A float sum's order follows the thread count, so
a bound must hold at any count; the spawning modules set their ranks' own
(``tests/torch_dist_ranks.py:THREADS``, one thread too).
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
