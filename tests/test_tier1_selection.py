"""What tier-1's ``-m 'not slow'`` selects.

A ``-m`` on the command line replaces pyproject.toml's ``addopts = "-m
'not soak'"``, so the hour soak stays out of tier-1 only through the
``slow`` mark that the root conftest.py puts on every ``soak`` test.
These collect in a subprocess: ``tests/`` once, for the soak tests
tier-1 would select, and ``tests/test_soak.py`` with ``-m soak`` (the
soak run) and with no ``-m`` (the default, which ``addopts`` governs)."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
HOUR = "tests/test_soak.py::test_soak_one_hour"


def collect(path: str, *marks: str) -> tuple[set[str], str]:
    res = subprocess.run(
        [sys.executable, "-m", "pytest", path, "--collect-only", "-q",
         "-p", "no:cacheprovider", *marks],
        capture_output=True, text=True, timeout=300, cwd=REPO)
    # 5: every test deselected
    assert res.returncode in (0, 5), res.stdout[-2000:] + res.stderr[-2000:]
    return ({line for line in res.stdout.splitlines() if "::" in line},
            res.stdout)


def test_tier1_leaves_out_the_soak():
    tier1_soak, out = collect("tests/", "-m", "not slow and soak")
    assert "deselected" in out, out[-2000:]
    assert not tier1_soak, sorted(tier1_soak)
    soak, _ = collect("tests/test_soak.py", "-m", "soak")
    assert HOUR in soak, sorted(soak)
    default, _ = collect("tests/test_soak.py")
    assert default and HOUR not in default, sorted(default)
