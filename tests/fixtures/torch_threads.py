"""Two torch threads while a module's tests run, the setting restored after.

The tier-1 run puts several pytest workers on the machine's cores, and
torch's default of one OpenMP thread per core in each of them oversubscribes
the cores: the threads spin between parallel regions and starve the other
workers' JAX compiles. Six concurrent runs of one inferencer test took
131 s each at the default of 8 threads and 60 s at 1 or 2 (measured on an
8-core host). A test module takes the fixture by importing it.
"""
import pytest
import torch

THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(THREADS, threads))
    yield
    torch.set_num_threads(threads)
