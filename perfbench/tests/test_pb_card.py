"""On the GPU: one short run of each cell through the entry, correct, with
its metrics. ``python -m pytest perfbench/tests -m cuda``."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no GPU")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", workload,
                        "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0 and out["metrics"]
