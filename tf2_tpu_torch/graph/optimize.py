"""Load-time graph passes. The port has ``fuse_stem_quantize`` and
``fuse_bottleneck_chains``; the other passes of ``tf2_tpu.graph.optimize``
come with later slices."""
from __future__ import annotations

from .ir import Graph, Node
from .shapes import activation_shapes


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


def _is_qconv(n: Node | None, k: int, relu: bool) -> bool:
    return (n is not None and n.op == "qconv2d"
            and tuple(n.attrs["kshape"][:2]) == (k, k)
            and tuple(n.attrs.get("strides", [1, 1])) == (1, 1)
            and n.attrs.get("groups", 1) == 1
            and bool(n.attrs.get("relu")) == relu
            and n.attrs.get("wfmt") == "int8"
            and (k == 1 or n.attrs.get("padding", "SAME") == "SAME"))


def fuse_bottleneck_chains(graph: Graph, params) -> tuple[Graph, dict]:
    """Rewrite runs of stride-1 residual bottleneck blocks (qconv2d 1x1
    relu -> qconv2d 3x3 relu -> qconv2d 1x1 -> qadd, with an identity or 1x1
    downsample residual) into ``qblockchain`` nodes, run by
    ``kernels/qblocks.py``.

    Matches int8-weight convs only (the chain kernel reads int8 weights).
    Matching is conservative: every intermediate value must have exactly the
    consumers the block structure implies. Each chain node takes the name of
    its last ``qadd``, the params c1, c2, c3 (and the downsample) of each
    block in order, and attrs ``blocks`` (``down``, ``relu``, ``sa``, ``sb``,
    ``so``, ``cm``, ``cout`` per block) and the chain's ``h`` and ``w``.
    """
    shapes = activation_shapes(graph, params)
    by_name = {n.name: n for n in graph.nodes}
    consumers: dict[str, list[Node]] = {}
    for n in graph.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n)
    outputs = set(graph.outputs)

    def cons(name):
        return consumers.get(name, [])

    def match_block(c1: Node):
        """c1 -> (block_meta, nodes, x_name, out_name) or None."""
        if not _is_qconv(c1, 1, True):
            return None
        x_name = c1.inputs[0]
        if c1.name in outputs or len(cons(c1.name)) != 1:
            return None
        c2 = cons(c1.name)[0]
        if not _is_qconv(c2, 3, True) or c2.name in outputs or len(cons(c2.name)) != 1:
            return None
        if c2.attrs["kshape"][2] != c2.attrs["kshape"][3]:
            return None
        c3 = cons(c2.name)[0]
        if not _is_qconv(c3, 1, False) or c3.name in outputs or len(cons(c3.name)) != 1:
            return None
        add = cons(c3.name)[0]
        if add.op != "qadd":
            return None
        other = [i for i in add.inputs if i != c3.name]
        if len(other) != 1:
            return None
        r = other[0]
        down = None
        if r != x_name:
            dn = by_name.get(r)
            if (not _is_qconv(dn, 1, False) or dn.inputs[0] != x_name
                    or dn.name in outputs or len(cons(dn.name)) != 1):
                return None
            down = dn
        # the add scales inputs[0] by sa: it must be the c3 branch
        if add.inputs[0] != c3.name:
            return None
        nodes = [c1, c2, c3, add] + ([down] if down else [])
        meta = {"c1": c1.name, "c2": c2.name, "c3": c3.name,
                "add": add.name, "down": down.name if down else None,
                "relu": bool(add.attrs.get("relu")),
                "sa": float(add.attrs["sa"]), "sb": float(add.attrs["sb"]),
                "so": float(add.attrs["so"])}
        return meta, nodes, x_name, add.name

    blocks_by_input: dict[str, tuple] = {}
    for n in graph.nodes:
        m = match_block(n)
        if m:
            blocks_by_input.setdefault(m[2], m)

    # maximal chains: the next block's input is this block's add, and the
    # add's consumers are exactly the next block's entry ops (its c1 and the
    # residual taker: the add itself or its downsample)
    position = {n.name: i for i, n in enumerate(graph.nodes)}
    used: set[str] = set()
    chains = []
    for blk in sorted(blocks_by_input.values(), key=lambda b: position[b[0]["c1"]]):
        if blk[0]["c1"] in used:
            continue
        chain = [blk]
        used.update(nd.name for nd in blk[1])
        while True:
            out = chain[-1][3]
            nxt = blocks_by_input.get(out)
            if nxt is None or nxt[0]["c1"] in used or out in outputs:
                break
            if {c.name for c in cons(out)} != {nxt[0]["c1"], nxt[0]["down"] or nxt[0]["add"]}:
                break
            chain.append(nxt)
            used.update(nd.name for nd in nxt[1])
        chains.append(chain)
    if not chains:
        return graph, dict(params)

    # each chain's nodes become one qblockchain node at its last add
    last_add = {chain[-1][3]: chain for chain in chains}
    dead = {nd.name for chain in chains for _, nodes, _, _ in chain for nd in nodes}
    new_nodes: list[Node] = []
    for n in graph.nodes:
        if n.name in last_add:
            chain = last_add[n.name]
            x_name = chain[0][2]
            pnames: list[str] = []
            battrs = []
            for meta, _, _, _ in chain:
                c1, c2, c3 = by_name[meta["c1"]], by_name[meta["c2"]], by_name[meta["c3"]]
                pnames += list(c1.params) + list(c2.params) + list(c3.params)
                if meta["down"]:
                    pnames += list(by_name[meta["down"]].params)
                battrs.append({"down": meta["down"] is not None, "relu": meta["relu"],
                               "sa": meta["sa"], "sb": meta["sb"], "so": meta["so"],
                               "cm": c1.attrs["kshape"][3], "cout": c3.attrs["kshape"][3]})
            xs = shapes[x_name]
            new_nodes.append(Node(n.name, "qblockchain", (x_name,), tuple(pnames),
                                  {"blocks": battrs, "h": xs[1], "w": xs[2]}))
        elif n.name not in dead:
            new_nodes.append(n)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              dict(graph.params), dict(graph.meta))
    g.validate()
    return g, dict(params)
