"""One torch intra-op thread for the port's CPU tests.

The port's tests run the kernels' plain versions: many small torch ops on
the CPU. The suite runs in several worker processes, and torch's default
of one intra-op thread per core then oversubscribes the machine: on 8
cores under the suite's load, a TOY logQ = 11 gate took 27.9 s with 8
threads and 0.61 s with one. A test module imports `one_torch_thread`;
its tests then run with one thread, and the count in use before is
restored after the module.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
