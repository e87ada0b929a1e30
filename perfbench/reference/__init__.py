"""The plain reference: the whole quantized forward of an artifact, worked
out from its ``graph.json`` and weights with plain PyTorch operations.

It imports nothing of the program under test (``tf2_tpu_torch``), of
``tf2_tpu`` or of JAX. Its arithmetic is a frozen copy of the port's plain
path: integer sums taken exactly in float64, then the f32 epilogue in
separate IEEE steps (multiply, add, round half to even, clip). So on any
device it gives the int8 codes that the program's kernels are built to give.

Ops are found by name: every module of this package that defines ``OPS``
(``{op name: fn(node, params, *inputs, ctx)}``) adds to the table, so a
configuration that brings a new op adds a module here and edits none.

``act_bits=4`` is the control: every int8 activation is put on the 4-bit
grid of the same range after the node that makes it, the precision a step
below the configuration's int8 (see ``PERF.md``).
"""
from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Ctx:
    """What an op needs besides its node: the batch the graph runs at."""
    batch: int


def _table() -> dict:
    ops = {}
    for info in pkgutil.iter_modules(__path__):
        mod = importlib.import_module(f"{__name__}.{info.name}")
        ops.update(getattr(mod, "OPS", {}))
    return ops


def _to_grid(q: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 codes on the grid of ``bits`` bits over the same range."""
    top = float(2 ** (bits - 1) - 1)
    q4 = torch.clamp(torch.round(q.to(torch.float32) * (top / 127.0)), -top, top)
    return torch.round(q4 * (127.0 / top)).to(torch.int8)


def forward(graph: dict, params: dict[str, torch.Tensor], images: torch.Tensor,
            act_bits: int = 8) -> torch.Tensor:
    """The graph's single output on ``images`` (NHWC f32, on the device the
    params are on). ``graph`` is the parsed ``graph.json``; its batch is
    taken from ``images``."""
    ops = _table()
    ctx = Ctx(batch=images.shape[0])
    (name_in,) = graph["inputs"]
    env = {name_in: images}
    for node in graph["nodes"]:
        fn = ops.get(node["op"])
        if fn is None:
            raise NotImplementedError(f"reference: no op {node['op']!r}")
        out = fn(node, params, *(env[i] for i in node["inputs"]), ctx=ctx)
        if act_bits < 8 and out.dtype == torch.int8:
            out = _to_grid(out, act_bits)
        env[node["name"]] = out
    (name_out,) = graph["outputs"]
    return env[name_out]
