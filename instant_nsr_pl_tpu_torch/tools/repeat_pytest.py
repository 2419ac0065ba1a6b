"""Run one pytest selection many times, each run in a process of its own, and
count the runs that failed: the failure rate of a test whose result can
change from run to run (float32 atomics summed in another order on the card).

    python -m instant_nsr_pl_tpu_torch.tools.repeat_pytest --runs 100 --expect 4 \\
        -- tests/test_torch_port_cuda.py --noconftest -k test_hash_backward_one_point

Everything after ``--`` goes to ``python -m pytest``. Each run writes a JUnit
XML report, and the script reads the run's counts twice: from that report
and from pytest's own summary line. It stops with an error where the two
disagree, where pytest's exit code does not match them (0 with no failure, 1
with one), or where a run did not run exactly ``--expect`` tests: a run that
skipped, collected nothing or crashed is never counted as a pass. It prints
one line per run and, as its last line, one JSON object: ``runs``,
``runs_failed`` (runs with a failed or erroneous test), ``runs_passed`` (runs
in which every test passed) and each failed test's count.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import xml.etree.ElementTree as ET

_SUMMARY = re.compile(r"(\d+) (passed|failed|errors?|skipped|deselected|xfailed|xpassed)\b")


def summary_counts(output: str) -> dict[str, int]:
    """The counts of pytest's last summary line ("1 failed, 3 passed, 350
    deselected in 14.36s"), keyed passed / failed / error / skipped / ...;
    an empty dict where the output holds no summary line."""
    for line in reversed(output.strip().splitlines()):
        found = _SUMMARY.findall(line)
        if found and re.search(r" in [0-9.]+s", line):
            return {("error" if word.startswith("error") else word): int(k) for k, word in found}
    return {}


def junit_counts(path: str) -> tuple[dict[str, int], list[str]]:
    """(passed / failed / error / skipped counts, ids of the failed or
    erroneous tests) of a pytest JUnit XML report."""
    root = ET.parse(path).getroot()
    counts = {"passed": 0, "failed": 0, "error": 0, "skipped": 0}
    bad = []
    for case in root.iter("testcase"):
        kinds = {child.tag for child in case}
        kind = ("failed" if "failure" in kinds else "error" if "error" in kinds
                else "skipped" if "skipped" in kinds else "passed")
        counts[kind] += 1
        if kind in ("failed", "error"):
            bad.append(f"{case.get('classname', '')}::{case.get('name', '')}")
    return counts, bad


def check_run(rc: int, output: str, xml_path: str, expect: int) -> tuple[bool, list[str]]:
    """(every test passed, failed test ids) of one run; raises RuntimeError
    where the summary line, the report, the exit code and ``expect``
    disagree."""
    said = summary_counts(output)
    counts, bad = junit_counts(xml_path)
    for key in ("passed", "failed", "error", "skipped"):
        if said.get(key, 0) != counts[key]:
            raise RuntimeError(f"summary line {said} and JUnit report {counts} disagree on {key}")
    if sum(counts.values()) != expect:
        raise RuntimeError(f"the run ran {sum(counts.values())} tests, not {expect}: {counts}")
    passed = counts["passed"] == expect
    if rc != (0 if passed else 1):
        raise RuntimeError(f"pytest exit code {rc} with counts {counts}")
    return passed, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, required=True, help="separate pytest runs")
    ap.add_argument("--expect", type=int, required=True, help="tests each run must run")
    ap.add_argument("pytest_args", nargs=argparse.REMAINDER, help="-- then pytest's arguments")
    args = ap.parse_args(argv)
    pytest_args = args.pytest_args[1:] if args.pytest_args[:1] == ["--"] else args.pytest_args
    failed = collections.Counter()
    runs_failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(args.runs):
            xml_path = os.path.join(tmp, f"run{i}.xml")
            cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                   f"--junitxml={xml_path}", *pytest_args]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            output = proc.stdout + proc.stderr
            try:
                passed, bad = check_run(proc.returncode, output, xml_path, args.expect)
            except (RuntimeError, OSError, ET.ParseError) as err:
                print(output[-4000:])
                print(f"run {i + 1}: {err}", file=sys.stderr)
                return 2
            runs_failed += not passed
            failed.update(bad)
            last = output.strip().splitlines()[-1]
            print(f"run {i + 1}: {'passed' if passed else 'FAILED ' + ' '.join(bad)} ({last})",
                  flush=True)
    print(json.dumps({"runs": args.runs, "runs_failed": runs_failed,
                      "runs_passed": args.runs - runs_failed, "failed_tests": dict(failed)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
