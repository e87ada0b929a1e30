"""Cells at sizes a CPU test can hold: the committed cells' traffic,
metrics and limits around tiny configurations."""
from __future__ import annotations

import time

import torch

from perfbench import manifest

SIZES = {"resnet": {"image_size": 32, "num_classes": 10, "depths": [1, 1, 1, 1]},
         "vit": {"image_size": 32, "hidden_size": 64, "num_hidden_layers": 1,
                 "num_attention_heads": 4, "intermediate_size": 256, "num_classes": 10}}


def config(name: str) -> dict:
    """The committed configuration ``name`` cut to a tiny size."""
    cell = next(c for c in (manifest.load(w) for w in WORKLOADS) if c.config["name"] == name)
    cfg = dict(cell.config, **SIZES[cell.config["family"]])
    cfg["name"] = f"{name}-tiny"
    return cfg


WORKLOADS = ("resnet50-w4pot.offline-b64", "vit-b16-w8.offline-b64", "resnet50-w4pot.stream-b1")


def cell(workload: str, traffic: dict | None = None) -> manifest.Cell:
    """The committed cell with a tiny configuration, a 4-image batch where
    it batches, and a small sample; ``traffic`` replaces its keys."""
    c = manifest.load(workload)
    b = min(c.traffic["batch"], 4)
    traffic = dict(c.traffic, batch=b, compare_calls=3, **(traffic or {}))
    return manifest.Cell(c.name, c.chips, config(c.config["name"]), traffic, c.limits,
                         c.end_to_end, c.per_layer)


def run(workload: str, traced: bool = False, seconds: float = 0.5, wrap=None,
        seed: int = 2**31 + 11, traffic: dict | None = None) -> dict:
    from perfbench import harness

    t0 = time.perf_counter()
    return harness.run(cell(workload, traffic), seed, seconds, traced, torch.device("cpu"),
                       lambda: time.perf_counter() - t0, wrap, warm_s=0.0)
