"""Structured channel pruning (the reference's, ``tf2_tpu/transform/
prune.py``).

- ``prune_channels`` removes the lowest-L1 output channels of eligible
  conv/dense layers from the graph, with the following batch_norm params
  and every consumer's input-channel dim: the artifact gets smaller and
  the forward cheaper. A value consumed by a join op (add / concat /
  attention / lrn) is left unpruned, so in bottleneck CNNs the
  block-internal convs are what shrinks.
- ``prune_params`` zeroes the same channels in place instead (the masked
  net computes what the pruned one does).

Eligibility walk: from a conv/dense output, follow channel-preserving ops
(relu/pool/dropout/..., batch_norm with its params sliced, flatten after
global pooling where the channel map is the identity). If every terminal
consumer is a groups=1 conv2d (weight axis 2) or a dense (weight axis 0)
and the value is not a graph output, the producer is prunable. Kept counts
round up to ``round_to`` (8), at least ``min_channels``: the widths the
card's kernels then take are multiples of 8.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..graph.ir import Graph, Node, TensorSpec

# ops through which a channel index passes unchanged
_PRESERVING = {"relu", "relu6", "identity", "dropout", "maxpool", "avgpool",
               "global_avgpool", "pad"}


@dataclasses.dataclass
class PruneSpec:
    fraction: float = 0.0            # fraction of out-channels removed per layer
    skip_first_last: bool = True
    min_channels: int = 8
    round_to: int = 8                # kept count rounds up to a multiple


def channel_l1(w: np.ndarray) -> np.ndarray:
    """Per-output-channel L1 norm; out channel is the last axis."""
    return np.sum(np.abs(w.reshape(-1, w.shape[-1])), axis=0)


def _keep_indices(w: np.ndarray, spec: PruneSpec) -> np.ndarray | None:
    c = w.shape[-1]
    n_drop = int(c * spec.fraction)
    keep = max(c - n_drop, spec.min_channels)
    keep = -(-keep // spec.round_to) * spec.round_to
    keep = min(keep, c)
    if keep >= c:
        return None
    norms = channel_l1(w)
    idx = np.sort(np.argsort(norms)[c - keep:])  # keep highest-L1, in order
    return idx


def _closure(graph: Graph, value: str, shapes) -> tuple[list, list] | None:
    """Follow channel-preserving consumers of ``value``. Returns
    (terminal consumer nodes, batch_norm nodes on the way) or None if any
    path hits a non-prunable consumer (add/concat/... or a graph output)."""
    cons = graph.consumers()
    if value in graph.outputs:
        return None
    terminals, bns = [], []
    frontier = [value]
    seen = set()
    while frontier:
        v = frontier.pop()
        if v in seen:
            continue
        seen.add(v)
        if v != value and v in graph.outputs:
            return None
        for n in cons.get(v, []):
            if n.op == "conv2d":
                if n.attrs.get("groups", 1) != 1:
                    return None
                terminals.append(n)
            elif n.op == "dense":
                terminals.append(n)
            elif n.op == "batch_norm":
                bns.append(n)
                frontier.append(n.name)
            elif n.op == "flatten":
                shp = shapes.get(n.inputs[0])
                # identity C-map only when all non-batch spatial dims are 1
                if shp is None or any(d != 1 for d in shp[1:-1]):
                    return None
                frontier.append(n.name)
            elif n.op in _PRESERVING:
                if n.op == "pad":
                    pads = n.attrs.get("pads", [])
                    if pads and tuple(pads[-1]) != (0, 0):
                        return None
                frontier.append(n.name)
            else:
                return None
    return terminals, bns


def prune_channels(graph: Graph, params: dict, spec: PruneSpec
                   ) -> tuple[Graph, dict, dict]:
    """PHYSICALLY remove low-L1 output channels. Returns
    (new_graph, new_params, report: node -> kept_fraction)."""
    new_params = {k: np.asarray(v) for k, v in params.items()}
    report: dict[str, float] = {}
    if spec.fraction <= 0:
        g = Graph(graph.name, dict(graph.inputs), graph.outputs,
                  [Node(n.name, n.op, n.inputs, n.params, dict(n.attrs))
                   for n in graph.nodes], dict(graph.params),
                  dict(graph.meta))
        return g, new_params, report

    from ..graph.shapes import activation_shapes
    shapes = activation_shapes(graph, params)
    compute = [n for n in graph.nodes if n.op in ("conv2d", "dense")]
    first = compute[0].name if compute else None
    last = compute[-1].name if compute else None

    new_specs = dict(graph.params)

    def slice_param(name: str, axis: int, idx: np.ndarray):
        arr = np.take(new_params[name], idx, axis=axis)
        new_params[name] = arr
        new_specs[name] = TensorSpec(arr.shape, new_specs[name].dtype)

    for n in compute:
        if spec.skip_first_last and n.name in (first, last):
            continue
        w = new_params[n.params[0]]
        idx = _keep_indices(w, spec)
        if idx is None:
            continue
        walk = _closure(graph, n.name, shapes)
        if walk is None:
            continue
        terminals, bns = walk
        # producer: weight last axis (+ bias)
        slice_param(n.params[0], new_params[n.params[0]].ndim - 1, idx)
        if len(n.params) > 1:
            slice_param(n.params[1], 0, idx)
        # batch_norms on the way: all four channel vectors
        for bn in bns:
            for p in bn.params:
                slice_param(p, 0, idx)
        # consumers: input-channel dim
        for t in terminals:
            axis = 2 if t.op == "conv2d" else 0
            slice_param(t.params[0], axis, idx)
        report[n.name] = len(idx) / w.shape[-1]

    g = Graph(graph.name, dict(graph.inputs), graph.outputs,
              [Node(n.name, n.op, n.inputs, n.params, dict(n.attrs))
               for n in graph.nodes], new_specs, dict(graph.meta))
    g.validate()
    return g, new_params, report


def prune_params(graph: Graph, params: dict, spec: PruneSpec,
                 only: set | None = None) -> tuple[dict, dict]:
    """Mask-only variant: zero the lowest-L1 output channels in place
    (artifact size unchanged; ``only`` restricts to named layers — e.g. the
    set prune_channels reports — for masked-vs-physical A/B studies)."""
    if spec.fraction <= 0:
        return dict(params), {}
    all_compute = [n for n in graph.nodes if n.op in ("conv2d", "dense")]
    first = all_compute[0].name if all_compute else None
    last = all_compute[-1].name if all_compute else None
    conv_nodes = [n for n in all_compute
                  if only is None or n.name in only]
    out = dict(params)
    report = {}
    for n in conv_nodes:
        if spec.skip_first_last and n.name in (first, last):
            continue
        wname = n.params[0]
        w = np.asarray(params[wname])
        idx = _keep_indices(w, spec)
        if idx is None:
            continue
        mask = np.zeros(w.shape[-1], w.dtype)
        mask[idx] = 1
        out[wname] = w * mask
        if len(n.params) > 1:
            out[n.params[1]] = np.asarray(params[n.params[1]]) * mask
        report[n.name] = float(mask.mean())
    return out, report
