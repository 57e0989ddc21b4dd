"""One torch thread for each of the port's CPU test files.

Tier-1 runs the suite on several workers at once (pytest-xdist).  Each
worker's torch would otherwise start a thread a core for its CPU kernels,
and a kernel's parallel region waits until every one of its threads has
had the CPU: with a worker a core already, small products and reductions
then take a scheduler's time slice each, and a test that takes seconds
alone takes many minutes in the suite.  Every tests/test_torch_*.py file
imports `one_torch_thread` (or sets one thread in a cap of its own), an
autouse fixture
that holds torch at one intra-op thread for the file's tests and puts the
count back after.  Ranks started by parallel/launch.py set their own
count (the cores over the ranks), as the mesh tests' emulations expect.
"""
import glob
import os
import re

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch's intra-op threads at one for the module's tests; yields the
    count it found (torch's own), which a test that needs it may restore
    for itself (tests/test_torch_net_repl.py)"""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield n
    torch.set_num_threads(n)


def test_a_port_test_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1


def test_every_port_test_file_caps_its_threads():
    """each tests/test_torch_*.py takes the cap: it imports this fixture
    or sets one thread itself"""
    here = os.path.dirname(os.path.abspath(__file__))
    files = sorted(glob.glob(os.path.join(here, "test_torch_*.py")))
    assert len(files) > 40
    cap = re.compile(r"^from tests\.test_torch_threads import one_torch_thread"
                     r"|torch\.set_num_threads\(1\)", re.M)
    missing = []
    for path in files:
        with open(path) as f:
            if not cap.search(f.read()):
                missing.append(os.path.basename(path))
    assert not missing, f"no thread cap in {missing}"
