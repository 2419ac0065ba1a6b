"""The repeated-run counter ``tools/repeat_pytest.py`` on the CPU: its reading
of pytest's summary line, and whole runs of a small test file with one
passing and one failing test, each count checked against what pytest said."""

import json

import pytest

from instant_nsr_pl_tpu_torch.tools import repeat_pytest as rp

_TESTS = """
def test_ok():
    assert True


def test_bad():
    assert False
"""


@pytest.mark.parametrize("line, counts", [
    ("4 passed, 462 deselected in 20.11s", {"passed": 4, "deselected": 462}),
    ("1 failed, 3 passed, 350 deselected in 14.36s",
     {"failed": 1, "passed": 3, "deselected": 350}),
    ("4 skipped in 0.52s", {"skipped": 4}),
    ("1 passed, 2 errors in 1.00s", {"passed": 1, "error": 2}),
    ("no tests ran in 0.01s", {}),
])
def test_summary_counts(line, counts):
    assert rp.summary_counts("collected\n" + line + "\n") == counts


def _run(tmp_path, capsys, runs, expect, *pytest_args):
    path = tmp_path / "test_pair.py"
    path.write_text(_TESTS)
    rc = rp.main(["--runs", str(runs), "--expect", str(expect), "--", str(path), *pytest_args])
    return rc, capsys.readouterr().out.strip().splitlines()


def test_counts_failing_runs(tmp_path, capsys):
    rc, lines = _run(tmp_path, capsys, 2, 2)
    assert rc == 0
    assert json.loads(lines[-1]) == {"runs": 2, "runs_failed": 2, "runs_passed": 0,
                                     "failed_tests": {"test_pair::test_bad": 2}}
    assert all("FAILED test_pair::test_bad" in line for line in lines[:2])


def test_counts_passing_runs(tmp_path, capsys):
    rc, lines = _run(tmp_path, capsys, 2, 1, "-k", "test_ok")
    assert rc == 0
    assert json.loads(lines[-1]) == {"runs": 2, "runs_failed": 0, "runs_passed": 2,
                                     "failed_tests": {}}


def test_stops_on_a_wrong_test_count(tmp_path, capsys):
    """A run that runs another number of tests than expected (here one
    deselected) is an error, not a pass."""
    rc, _ = _run(tmp_path, capsys, 1, 2, "-k", "test_ok")
    assert rc == 2
