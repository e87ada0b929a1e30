"""Debugging tools of the port, the counterparts of
``tf2_tpu/utils/debug.py``:

- ``plain_mode()``: every node runs its plain PyTorch version, the port's
  stand-in for the reference's ``interpret_mode`` (Pallas interpreted)
  when kernel logic is debugged;
- ``checked_execute``: an executor that checks each node's output (NaN,
  inf) and the index inputs of the table gathers as it goes, the
  counterpart of the reference's checkify-guarded one;
- ``check_finite``: the first node with a non-finite float output;
- ``compare_backends``: the kernels against the plain versions, node by
  node, on one device;
- ``compare_shardings``: a meshed Engine's partition checked node by node.

Each check syncs with the host; nothing on the serving path calls them.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..graph.execute import execute, run_node, set_plain_mode
from ..graph.ir import Graph
from ..transform.calibrate import _on

# op -> (table size, offset added to the input): the gathers whose index
# input ``checked_execute`` checks before the node runs
TABLE_GATHERS = {"qgelu": (256, 128)}


@contextlib.contextmanager
def plain_mode():
    """Inside the block every node takes its plain version: the nodes of any
    ``execute`` forward and of every eager Engine forward, whatever they
    were built to run (kernels, ``library`` routes). It is read at one
    place, ``graph/execute.run_node``, so an Engine made inside the block
    and run after it launches its kernels again, and a built Engine's
    replay (captured before) is not changed. Process-wide; the previous
    setting comes back on leaving, also after an exception."""
    prev = set_plain_mode(True)
    try:
        yield
    finally:
        set_plain_mode(prev)


def checked_execute(graph: Graph, device: str | torch.device = "cuda"):
    """An executor that checks as it runs: fn(params, **inputs) -> outputs
    (params and inputs: arrays or tensors, moved to ``device``). Before a
    table gather (``TABLE_GATHERS``: ``qgelu``) its index input must lie in
    the table, else ``IndexError``; after each node every float output must
    be finite, else ``FloatingPointError`` naming the node, its op and the
    kind (``nan`` before ``inf``). Torch has no checkify, so each check is a
    host sync: a debug tool. A node no kernel takes raises on the card
    (``NotImplementedError``: only an Engine's plan runs a node plain
    there); run such a graph through an Engine, or under ``plain_mode``."""
    from ..runtime.engine import resolve_device

    device = resolve_device(device)

    def fn(params, **inputs):
        p = _on(params, device)
        env = _on(inputs, device)
        for node in graph.nodes:
            args = [env[i] for i in node.inputs]
            if node.op in TABLE_GATHERS:
                size, offset = TABLE_GATHERS[node.op]
                idx = args[0]
                lo, hi = int(idx.min()) + offset, int(idx.max()) + offset
                if idx.is_floating_point() or lo < 0 or hi >= size:
                    raise IndexError(f"node {node.name} ({node.op}): index out of range: "
                                     f"[{lo}, {hi}] into a table of {size}")
            out = run_node(node, p, *args)
            for v in out if isinstance(out, tuple) else (out,):
                if v.is_floating_point():
                    for kind, bad in (("nan", torch.isnan), ("inf", torch.isinf)):
                        if bool(bad(v).any()):
                            raise FloatingPointError(
                                f"node {node.name} ({node.op}): {kind} in its output")
            env[node.name] = out
        outs = tuple(env[o] for o in graph.outputs)
        return outs[0] if len(outs) == 1 else outs

    return fn


def check_finite(graph: Graph, params, device: str | torch.device = "cuda",
                 **inputs) -> str | None:
    """The name of the first node (in graph order) with a non-finite value
    in a float output, or None if every one is finite; from
    ``execute(graph, intermediates=True)`` on ``device``."""
    from ..runtime.engine import resolve_device

    device = resolve_device(device)
    _, env = execute(graph, intermediates=True)(_on(params, device), **_on(inputs, device))
    for node in graph.nodes:
        v = env[node.name]
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            return node.name
    return None


def compare_backends(graph: Graph, params, atol_quanta: int = 0,
                     device: str | torch.device = "cuda", **inputs) -> list[dict]:
    """The graph on ``device`` twice, with its kernels (``execute(...,
    intermediates=True)``) and with every node plain (``plain=True``): the
    int8 nodes whose outputs differ by more than ``atol_quanta``, each with
    ``max_quanta`` and ``frac_diff`` (empty: every int8 node within it).
    ``graph`` and ``params`` as an Engine holds them (``Engine.graph``,
    ``Engine.params``: weights prepared at load) or as an artifact has them
    (each wrapper then prepares its weight per call). On the CPU both runs
    are plain, so the result is empty. The kernels are bit-exact to their
    plain versions, so the default is 0 where the reference allows 1.5
    (XLA against Pallas); no interpreter is entered."""
    from ..runtime.engine import resolve_device

    device = resolve_device(device)
    p, x = _on(params, device), _on(inputs, device)
    _, env_ker = execute(graph, intermediates=True)(p, **x)
    _, env_ref = execute(graph, intermediates=True, plain=True)(p, **x)
    findings = []
    for node in graph.nodes:
        a, b = env_ref[node.name], env_ker[node.name]
        if a.dtype == torch.int8:
            diff = (a.to(torch.int32) - b.to(torch.int32)).abs()
            worst = int(diff.max()) if diff.numel() else 0
            if worst > atol_quanta:
                findings.append({"node": node.name, "op": node.op, "max_quanta": worst,
                                 "frac_diff": float((diff > 0).double().mean())})
    return findings


def compare_shardings(meshed, whole, atol_quanta: int = 0, min_exact: float = 1.0,
                      **inputs) -> list[dict]:
    """Per-node localization of a mesh's partitioning divergence, teacher
    forced: every int8 node of ``meshed``'s graph (a meshed Engine) runs on
    this rank's part of the inputs the unmeshed Engine ``whole`` (the same
    artifact and options) computed for it, and must equal this rank's part
    of ``whole``'s node (its rows under dp, its output channels for a tp
    node) within ``atol_quanta`` everywhere and bit for bit on at least
    ``min_exact`` of the elements. ``inputs``: the global batch. Returns
    the offending nodes (empty = gate passed).

    The port's partition is exact (a tp node's requant is per output
    channel, dp rows are independent), so the defaults are 0 and 1.0 where
    the reference allows a quantum for XLA's partitioned sums."""
    _, env = execute(whole.graph, intermediates=True, kernels=whole.kernels)(
        whole.params, **{k: torch.as_tensor(v).to(whole.device) for k, v in inputs.items()})
    rows = slice(*meshed.rows) if meshed.rows is not None else slice(None)
    local = {k: v[rows] for k, v in env.items()}
    findings = []
    for node in meshed.graph.nodes:
        want = local.get(node.name)
        if want is not None and want.dtype != torch.int8:
            continue
        got = run_node(node, meshed.params, *(local[i] for i in node.inputs),
                       kernel=meshed.kernels.get(node.name))
        if want is None:   # a node the tp cut added (a residual's slice)
            local[node.name] = got
            continue
        if node.name in meshed.tp_nodes:   # this rank's channels, tp_index-th of tp
            per = got.shape[-1]
            want = want[..., meshed.mesh.tp_index * per:(meshed.mesh.tp_index + 1) * per]
        diff = np.abs(want.cpu().numpy().astype(np.int32) - got.cpu().numpy().astype(np.int32))
        exact = float((diff == 0).mean())
        if diff.max() > atol_quanta or exact < min_exact:
            findings.append({"node": node.name, "op": node.op, "max_quanta": int(diff.max()),
                             "exact_frac": exact})
    return findings
