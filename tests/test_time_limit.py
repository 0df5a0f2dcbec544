"""The suite's rules in the root ``conftest.py``: its time limit and its slow files."""

import pathlib
import re
import signal
import time
import types

import pytest

from conftest import LIMIT, SLOW_FILES, pytest_collection_modifyitems, time_limit


def test_time_limit_fails_a_body_past_its_limit():
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match=r"sleeper .* limit of 0\.2 s"):
        with time_limit(0.2, "sleeper"):
            time.sleep(5)
    assert time.monotonic() - start < 1.0


def test_time_limit_puts_back_the_timer_and_handler_it_found():
    handler = signal.getsignal(signal.SIGALRM)
    with time_limit(5, "quick"):
        time.sleep(0.01)
    assert signal.getsignal(signal.SIGALRM) is handler
    delay, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < delay <= LIMIT


def _expires_naming(nodeid):
    delay, _ = signal.getitimer(signal.ITIMER_REAL)
    assert 0 < delay <= LIMIT
    expire = signal.getsignal(signal.SIGALRM)
    message = re.escape(f"{nodeid} ran past its time limit of {LIMIT:g} s")
    with pytest.raises(pytest.fail.Exception, match=message):
        expire(signal.SIGALRM, None)
    return True


def test_each_test_runs_under_the_limit_with_its_node_id(request):
    assert _expires_naming(request.node.nodeid)


@pytest.fixture
def setup_checked(request):
    return _expires_naming(request.node.nodeid)


def test_fixtures_run_under_the_limit_with_the_node_id(setup_checked):
    assert setup_checked


def test_only_the_slow_files_are_marked_slow():
    def item(name):
        marks = []
        return types.SimpleNamespace(path=pathlib.Path("tests", name), marks=marks,
                                     add_marker=marks.append)

    items = [item(name) for name in sorted(SLOW_FILES)] + [item("test_torch_march.py")]
    pytest_collection_modifyitems(items)
    assert [[m.name for m in it.marks] for it in items] == [["slow"]] * len(SLOW_FILES) + [[]]
