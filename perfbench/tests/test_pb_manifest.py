"""BENCHMARK.json against the benchmark's contract, as far as a file can
show it: keys, names, the files each entry names, the readers of its
metrics, and the run budget."""
import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert B["paths"] == ["perfbench"] and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) < 64 * 1024
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").exists()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").exists()
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in B[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in B[k]}) == len(B[k])
    assert all(UNIT.match(m["unit"]) for m in B["end_to_end"] + B["per_layer"])


def _reports(metric, cell):
    return cell in metric.get("workloads", [w["name"] for w in B["workloads"]])


@pytest.mark.parametrize("cell", [w["name"] for w in B["workloads"]])
def test_each_cell_reports(cell):
    e2e = [m for m in B["end_to_end"] if _reports(m, cell)]
    per = [m for m in B["per_layer"] if _reports(m, cell)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    for m in per:
        assert m["moves"] in {x["name"] for x in e2e}


@pytest.mark.parametrize("metric", B["end_to_end"] + B["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    mod = importlib.import_module(f"perfbench.metrics.{metric['name'].split('.')[0]}")
    assert callable(mod.read)


def test_run_budget_fits_full_benchmark():
    cells = 24
    assert 2 + 14 * cells * (B["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_traffic_files_hold_only_what_the_generator_reads():
    for f in (ROOT / "perfbench" / "traffic").iterdir():
        t = json.loads(f.read_text())
        assert {"scenario", "batch", "compare_calls"} <= set(t)
        assert set(t) <= {"scenario", "batch", "compare_calls", "rate_per_s"}, f.name


def test_limits_files():
    for w in B["workloads"]:
        lim = json.loads((ROOT / "perfbench" / "limits" / f"{w['name']}.json").read_text())
        assert set(lim) == {"max_gap_codes", "mismatch_pct"}
        assert all(v["limit"] >= 0 for v in lim.values())
