"""Load-time graph passes. This slice ports ``fuse_stem_quantize``; the
other passes of ``tf2_tpu.graph.optimize`` come with later slices."""
from __future__ import annotations

from .ir import Graph, Node


def fuse_stem_quantize(graph: Graph, params) -> tuple[Graph, dict]:
    """Fold the input ``quantize`` node into its consuming stem qconv2d: the
    node is deleted and its scale stamped on the conv as attr ``s_in``, so
    the conv quantizes the raw f32 image itself.

    Applies when a quantize node consumes a graph input, is not itself a
    graph output, and its only consumer is a qconv2d with cin <= 4.
    """
    quants = {n.name: n for n in graph.nodes if n.op == "quantize"
              and n.inputs[0] in graph.inputs}
    consumers: dict[str, list[Node]] = {q: [] for q in quants}
    for n in graph.nodes:
        for i in n.inputs:
            if i in quants:
                consumers[i].append(n)
    stems = {cons[0].name: q for q, cons in consumers.items()
             if q not in graph.outputs and len(cons) == 1
             and cons[0].op == "qconv2d" and cons[0].attrs["kshape"][2] <= 4}
    if not stems:
        return graph, dict(params)
    fused = set(stems.values())
    new_nodes = []
    for n in graph.nodes:
        if n.name in fused:
            continue
        if n.name in stems:
            q = quants[stems[n.name]]
            n = Node(n.name, n.op, (q.inputs[0],), n.params,
                     dict(n.attrs, s_in=float(q.attrs["scale"])))
        new_nodes.append(n)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              dict(graph.params), dict(graph.meta))
    g.validate()
    return g, dict(params)
