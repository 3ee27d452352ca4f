"""An autouse fixture for the port's CPU test files that run many small
tensor ops (toy models, toy training steps): one intra-op thread for the
module. The test suite runs in several worker processes at once, and
torch's default of one thread per core in each of them oversubscribes the
cores; at these sizes one thread loses little alone and much less under
contention. Import it into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
