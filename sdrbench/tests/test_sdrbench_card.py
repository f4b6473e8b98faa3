"""On the card: a short run of the north-star cell through the command,
correct, with every end-to-end metric.  Skips without a card.

    python -m pytest -m cuda sdrbench/tests/test_sdrbench_card.py
"""

import json
import subprocess
import sys

import pytest

import sdrbench_cells

pytestmark = pytest.mark.cuda


def test_north_star_cell_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    got = subprocess.run(
        [sys.executable, "-m", "sdrbench", "--workload", "iq35.mixed128",
         "--seed", "2147483999", "--seconds", "3", "--trace", "0"],
        cwd=sdrbench_cells.REPO, capture_output=True, text=True,
        timeout=1200)
    assert got.returncode == 0, got.stderr[-3000:]
    out = json.loads(got.stdout.strip().splitlines()[-1])
    assert out["correct"], got.stderr[-3000:]
    assert set(out["metrics"]) == {"msps", "setup_s"}
