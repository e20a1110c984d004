"""Suite-wide test settings: the port's one thread rule, and the order in
which pytest-xdist's loadfile schedule hands the tests to its workers.

tests/conftest.py (harp_tpu's, loaded after this file) puts JAX on the CPU
with its 8-device mesh. Nothing here imports JAX, torch or xdist at import
time, so the card-only runs and the benchmark's own tests load it as they
are.
"""

import itertools
import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def port_tests_on_one_thread(request):
    """Every port test file (tests/test_torch_*.py) runs torch on one
    intra-op thread: the port's fits and steps are bit-equal on the CPU only
    so (PyTorch's CPU backward of a gather accumulates in parallel), and a
    thread pool in each of the suite's parallel workers oversubscribes the
    cores (tests of under a second took minutes, a CLI test 256 s instead
    of 8 s)."""
    if not request.path.name.startswith("test_torch_"):
        yield
        return
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# harp_tpu's end-to-end fits are one file of 14 tests that share no fixture
# and sum to 1,100-1,600 s under the tier-1 command: on one worker they set
# the run's end, so the schedule hands out each of their tests alone.
SPLIT_BY_TEST = ("tests/test_fit_e2e.py",)

# The units that start first among their kind (below). A name here is a
# file, or a test of a SPLIT_BY_TEST file.
LONG_FIRST = (
    "tests/test_fit_e2e.py::test_reference_exact_preset_fit",
    "tests/test_parallel.py",  # harp_tpu's 8-device mesh tests, 400-500 s
)


def _scope(nodeid: str) -> str:
    """The unit of work xdist hands a worker: a file, or a test with all its
    parameter cases for a SPLIT_BY_TEST file."""
    path = nodeid.split("::", 1)[0]
    return nodeid.split("[", 1)[0] if path in SPLIT_BY_TEST else path


def _rank(scope: str) -> int:
    for i, name in enumerate(LONG_FIRST):
        if scope == name or scope.startswith(name + "::"):
            return i
    return len(LONG_FIRST)


def pytest_configure(config):
    for name in LONG_FIRST + SPLIT_BY_TEST:  # a stale name fails every run at once
        path, _, test = name.partition("::")
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), path)) as f:
            assert not test or f"def {test}(" in f.read(), f"conftest.py names {name}"
    # Without this, xdist sorts the units by number of tests, and a file of
    # few long tests starts last.
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


def pytest_collection_modifyitems(config, items):
    """The workers' queue: the end-to-end tests, the port's files and
    harp_tpu's other files taken in turns, each kind in path order after its
    LONG_FIRST units. Started all at once, the end-to-end fits slowed each
    other (builder's 8-core CPU): the reference-exact fit took 510 s, and
    457 s taken in turns."""
    kinds = ([], [], [])
    for scope in dict.fromkeys(_scope(item.nodeid) for item in items):
        path = scope.split("::", 1)[0]
        port = os.path.basename(path).startswith("test_torch_")
        kinds[0 if path in SPLIT_BY_TEST else 1 if port else 2].append(scope)
    order = [s for turn in itertools.zip_longest(*(sorted(k, key=_rank) for k in kinds))
             for s in turn if s is not None]
    place = {scope: i for i, scope in enumerate(order)}
    items.sort(key=lambda item: place[_scope(item.nodeid)])


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class SplitLoadFileScheduling(LoadFileScheduling):
        """loadfile, with each test of a SPLIT_BY_TEST file a unit of its own."""

        def _split_scope(self, nodeid):
            return _scope(nodeid)

    return SplitLoadFileScheduling(config, log)
