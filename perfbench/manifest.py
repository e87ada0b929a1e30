"""A cell of ``BENCHMARK.json`` and the files it names: the configuration
(its ``file``), the traffic mix (``traffic/<traffic>.json``), the limits of
the comparison that decides ``correct`` (``limits/<workload>.json``) and the
metrics the cell reports (a metric without ``workloads`` is reported by
every cell)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]


def _mine(metrics, cell: str) -> tuple[dict, ...]:
    return tuple(m for m in metrics if cell in m.get("workloads", (cell,)))


def load(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``manifest`` (default: ``root/BENCHMARK.json``);
    its files are read relative to ``root``."""
    if manifest is None:
        manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    (cfg_entry,) = [c for c in manifest["configs"] if c["name"] == w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "perfbench" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((root / "perfbench" / "limits" / f"{name}.json").read_text())
    return Cell(name, int(w["chips"]), config, traffic, limits,
                _mine(manifest["end_to_end"], name), _mine(manifest["per_layer"], name))
