"""The result line: its keys, in the order the line gives them, from a
whole run of a tiny cell on the CPU (the harness's look for a GPU skipped),
and the entry's refusal without a GPU."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
@pytest.mark.parametrize("traced", [False, True])
def test_line_keys(workload, traced):
    out = tiny.run(workload, traced)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["compared"]) == {"max_gap_codes", "mismatch_pct"}
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"} and c["value"] == 0.0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    cell = tiny.cell(workload)
    names = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not traced:   # host-clock metrics are there on the CPU too
        assert set(out["metrics"]) == names
    json.dumps(out)


@pytest.mark.parametrize("traced", [False, True])
def test_open_loop_mix_runs_from_data_alone(traced):
    """A mix that is only data (Poisson arrivals at ``rate_per_s``) runs
    through the same generator, correct, with the stream cells' metrics."""
    out = tiny.run("resnet50-w4pot.stream-b1", traced, seconds=1.0,
                   traffic={"scenario": "open loop", "rate_per_s": 40.0})
    assert out["correct"] is True and 20 <= out["attempted"] <= 80
    if not traced:
        assert out["metrics"]["latency_p95_ms"]["value"] > 0


def test_entry_refuses_without_a_gpu():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        tiny.WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""


def test_entry_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload",
                        tiny.WORKLOADS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
