"""BN folding: fold inference-time batch_norm into the preceding
conv2d/dense.

w' = w * (gamma / sqrt(var + eps))   (over the output-channel axis, last in
                                      HWIO and (Cin, Cout) layouts)
b' = (b - mean) * gamma / sqrt(var + eps) + beta

A ``layer_scale`` (ConvNeXt's gamma) folds the same way, as a batch norm
with mean 0, offset 0 and gamma / sqrt(var + eps) = gamma: w' = w * gamma,
b' = b * gamma.
"""
from __future__ import annotations

import numpy as np

from ..graph.ir import Graph, Node, TensorSpec


def fold_batch_norm(graph: Graph, params: dict) -> tuple[Graph, dict]:
    """Returns (new_graph, new_params). BN and layer-scale nodes whose
    sole producer is a conv2d/dense are folded away; any that can't fold
    stays."""
    node_map = graph.node_map()
    consumers = graph.consumers()
    new_params = dict(params)
    new_param_specs = dict(graph.params)
    rename: dict[str, str] = {}   # bn node name -> producer value name
    add_bias: dict[str, str] = {}  # conv node name -> new bias param name

    for node in graph.nodes:
        if node.op not in ("batch_norm", "layer_scale"):
            continue
        src = node.inputs[0]
        prod = node_map.get(src)
        if prod is None or prod.op not in ("conv2d", "dense"):
            continue
        if len(consumers.get(src, [])) != 1:
            continue  # conv output used elsewhere: folding would change it
        if node.op == "layer_scale":
            inv = np.asarray(params[node.params[0]], np.float32)
            mean = offset = np.float32(0)
        else:
            scale, offset, mean, var = (np.asarray(params[p], np.float32)
                                        for p in node.params)
            inv = scale / np.sqrt(var + node.attrs.get("eps", 1e-5))
        wname = prod.params[0]
        w = np.asarray(params[wname], np.float32)
        new_params[wname] = w * inv
        if len(prod.params) > 1:
            bname = prod.params[1]
            b = np.asarray(params[bname], np.float32)
        else:
            bname = f"{prod.name}.b"
            b = np.zeros(w.shape[-1], np.float32)
            add_bias[prod.name] = bname
            new_param_specs[bname] = TensorSpec((w.shape[-1],), "float32")
        new_params[bname] = (b - mean) * inv + offset
        for p in node.params:
            new_params.pop(p, None)
            new_param_specs.pop(p, None)
        rename[node.name] = src

    def remap(v: str) -> str:
        while v in rename:
            v = rename[v]
        return v

    new_nodes = []
    for node in graph.nodes:
        if node.name in rename:
            continue
        pl = list(node.params)
        if node.name in add_bias:
            pl.append(add_bias[node.name])
        new_nodes.append(Node(node.name, node.op,
                              tuple(remap(i) for i in node.inputs),
                              tuple(pl), dict(node.attrs)))
    g = Graph(graph.name, dict(graph.inputs),
              tuple(remap(o) for o in graph.outputs),
              new_nodes, new_param_specs, dict(graph.meta))
    g.validate()
    return g, new_params
