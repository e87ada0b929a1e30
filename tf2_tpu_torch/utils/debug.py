"""Debugging tools of the port. ``compare_shardings``, the counterpart of
``tf2_tpu/utils/debug.py:70-106``: a meshed Engine's partition checked
node by node. The rest of the reference's ``debug.py`` is still to port."""
from __future__ import annotations

import numpy as np
import torch

from ..graph.execute import execute, run_node


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
    _, env = execute(whole.graph, intermediates=True, plain_nodes=whole.plain_nodes,
                     library_nodes=whole.library_nodes)(
        whole.params, **{k: torch.as_tensor(v).to(whole.device) for k, v in inputs.items()})
    rows = slice(*meshed.rows) if meshed.rows is not None else slice(None)
    local = {k: v[rows] for k, v in env.items()}
    findings = []
    for node in meshed.graph.nodes:
        want = local.get(node.name)
        if want is not None and want.dtype != torch.int8:
            continue
        got = run_node(node, meshed.params, *(local[i] for i in node.inputs),
                       plain=node.name in meshed.plain_nodes,
                       library=node.name in meshed.library_nodes)
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
