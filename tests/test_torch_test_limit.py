"""The wall-time limit of every test (the repository's root ``conftest.py``),
run on a small tree of its own: pytest in a subprocess with ``-n 2 --dist
loadfile``, whose conftest takes the same hooks with a 2 s limit. A test
that blocks in a C-level wait (a lock acquired twice, as a deadlocked
thread waits) costs one failure, its stacks are printed and the run ends;
one that blocks every time still lets the run end."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT_CONFTEST = Path(__file__).resolve().parents[1] / "conftest.py"

CONFTEST = """\
import importlib.util

_spec = importlib.util.spec_from_file_location("limit_under_test", {path!r})
limit = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(limit)
limit.LIMIT = 2
pytest_configure = limit.pytest_configure
pytest_unconfigure = limit.pytest_unconfigure
pytest_runtest_protocol = limit.pytest_runtest_protocol
pytest_runtest_setup = limit.pytest_runtest_setup
"""

BLOCKS = """\
import os
import threading
from pathlib import Path


def test_before():
    pass


def test_blocks():
    seen = Path({seen!r})
    if {always} or not seen.exists():
        seen.write_text("blocked")
        lock = threading.Lock()
        lock.acquire()
        lock.acquire()


def test_after():
    pass
"""

OTHER = """\
def test_other_file():
    pass
"""


def _run(tmp_path: Path, always: bool) -> subprocess.CompletedProcess:
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "pytest.ini").write_text("[pytest]\n")
    (tree / "conftest.py").write_text(CONFTEST.format(path=str(ROOT_CONFTEST)))
    (tree / "test_blocks.py").write_text(
        BLOCKS.format(seen=str(tmp_path / "seen"), always=always))
    (tree / "test_other.py").write_text(OTHER)
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env["TMPDIR"] = str(tmp_path)
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "xdist", "-n", "2", "--dist", "loadfile",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rf", str(tree)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("always", [False, True], ids=["blocks_once", "blocks_always"])
def test_hung_test_costs_a_failure_and_the_run_ends(tmp_path, always):
    run = _run(tmp_path, always)
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "Timeout (0:00:02)!" in run.stderr, out
    assert "in test_blocks" in run.stderr, out    # the hung test's own frame
    assert "crashed while running 'test_blocks.py::test_blocks'" in run.stdout, out
    summary = run.stdout.strip().splitlines()[-1]
    if always:  # two crashes, then an error in setup: not run a third time
        assert "ran out its 2 s limit 2 times in this run; not run again" in run.stdout, out
        assert summary.startswith("2 failed, 3 passed, 1 error in "), out
    else:       # the crash, then the test sent again passes
        assert summary.startswith("1 failed, 4 passed in "), out
    assert not list(tmp_path.glob("pytest-limit-*")), "the run's marks were left behind"
