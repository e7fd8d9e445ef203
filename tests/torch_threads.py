"""One torch intra-op thread for each port test that imports this fixture.

The suite runs in parallel worker processes; each worker's full OpenMP pool
would oversubscribe the machine's cores. Test modules take the fixture by
importing it (``from torch_threads import one_torch_thread``); the thread
count is put back after each test, so other modules keep torch's default.
"""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
