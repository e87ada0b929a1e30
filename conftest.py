"""A wall-time limit on every test, so that one hung test costs one failure
and the suite still ends.

Around each test's setup, call and teardown a ``faulthandler`` watchdog is
armed for ``LIMIT`` seconds. When it runs out it writes every thread's
stack to the run's stderr (a descriptor duplicated before pytest captures
output, as pytest's own ``faulthandler`` plugin keeps one) and ends the
process. Under ``pytest-xdist`` the controller then reports the test
failed ("worker crashed") and starts a new worker, which takes up the rest
of the file.

xdist sends a crashed test again. A test that starts and never finishes
leaves a mark in a directory of this run (``tempfile.gettempdir()``, keyed
by xdist's ``testrunuid``): it runs once more under the limit, and once it
has run out the limit twice, any later send fails at once. A test that
hangs every time so costs two limits.

No ``jax`` or ``torch`` here: ``tests/conftest.py`` must set the JAX
platform before jax loads.
"""
from __future__ import annotations

import faulthandler
import hashlib
import os
import shutil
import sys
import tempfile
import uuid
from pathlib import Path

import pytest

LIMIT = 300          # seconds a test may take, setup and teardown included
TRIES = 2            # sends of one test that may run out the limit

_stderr: int | None = None   # stderr, duplicated before capture
_spent: set[str] = set()      # tests sent again after running out the limit TRIES times


def _marks(testrunuid: str | None) -> Path | None:
    return Path(tempfile.gettempdir()) / f"pytest-limit-{testrunuid}" if testrunuid else None


def _testrunuid(config) -> str | None:
    worker = getattr(config, "workerinput", None)
    if worker is not None:
        return worker.get("testrunuid")
    return getattr(config.option, "testrunuid", None)


def pytest_configure(config):
    global _stderr
    _stderr = os.dup((sys.__stderr__ or sys.stderr).fileno())
    if (getattr(config, "workerinput", None) is None and hasattr(config.option, "testrunuid")
            and config.option.testrunuid is None):
        # the controller names the run, so that it can remove the marks after
        config.option.testrunuid = uuid.uuid4().hex


def pytest_unconfigure(config):
    global _stderr
    if getattr(config, "workerinput", None) is None:
        marks = _marks(_testrunuid(config))
        if marks is not None:
            shutil.rmtree(marks, ignore_errors=True)
    if _stderr is not None:
        os.close(_stderr)
        _stderr = None


def _mark(item) -> Path | None:
    marks = _marks(_testrunuid(item.config))
    if marks is None:
        return None
    marks.mkdir(parents=True, exist_ok=True)
    return marks / hashlib.sha256(item.nodeid.encode()).hexdigest()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    mark = _mark(item)
    tries = int(mark.read_text()) if mark is not None and mark.exists() else 0
    if tries >= TRIES:
        _spent.add(item.nodeid)
    elif mark is not None:
        mark.write_text(str(tries + 1))
    faulthandler.dump_traceback_later(LIMIT, exit=True, file=_stderr)
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if mark is not None:
            mark.unlink(missing_ok=True)


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    if item.nodeid in _spent:
        pytest.fail(f"ran out its {LIMIT} s limit {TRIES} times in this run; not run again",
                    pytrace=False)
