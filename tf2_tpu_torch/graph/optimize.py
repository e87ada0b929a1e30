"""Graph passes. The port has the transform-time ``patchify_stem`` and the
load-time ``fuse_stem_quantize``, ``fuse_lrn_quantize``,
``hoist_input_quantize``, ``pack_phase_stem``, ``merge_sibling_1x1``,
``fuse_bottleneck_chains`` and ``space_to_depth_stem``: every pass of
``tf2_tpu.graph.optimize``. Each emits the graph the reference's pass emits
for the same input."""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from .ir import Graph, Node, TensorSpec
from .shapes import activation_shapes

log = logging.getLogger(__name__)


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


def patchify_stem(graph: Graph, params) -> tuple[Graph, dict]:
    """Rewrite each conv2d whose stride equals its kernel (the ViT patch
    embedding) as reshape -> transpose -> reshape -> dense, exactly: every
    output position reads each element of its patch once, so
    out[b, oy, ox, :] = patch(b, oy, ox) @ W.reshape(kh * kw * cin, cout).

    Runs on the folded f32 graph, before calibration, so the quantizer sees
    a dense. Matches ungrouped convs with a kernel larger than 1x1 whose
    input height and width the kernel divides, VALID or SAME padding. The
    reference's pass swallows a failure of ``activation_shapes`` and
    returns the graph unchanged; this one raises.
    """
    shapes = activation_shapes(graph, params)
    new_nodes: list[Node] = []
    new_params = dict(params)
    new_specs = dict(graph.params)
    changed = False
    for n in graph.nodes:
        if n.op != "conv2d":
            new_nodes.append(n)
            continue
        w = np.asarray(params[n.params[0]])
        kh, kw, cin, cout = w.shape
        sh, sw = n.attrs.get("strides", [1, 1])
        xshape = shapes[n.inputs[0]]
        if ((sh, sw) != (kh, kw) or (kh, kw) == (1, 1) or n.attrs.get("groups", 1) != 1
                or xshape[1] % kh or xshape[2] % kw
                or n.attrs.get("padding", "SAME") not in ("VALID", "SAME")):
            new_nodes.append(n)
            continue
        b_, h, wd, _ = xshape
        oh, ow = h // kh, wd // kw
        r1, tr, r2 = f"{n.name}__p1", f"{n.name}__pt", f"{n.name}__p2"
        new_nodes.append(Node(r1, "reshape", (n.inputs[0],), (),
                              {"shape": [b_, oh, kh, ow, kw, cin], "batch_leading": True}))
        new_nodes.append(Node(tr, "transpose", (r1,), (), {"perm": [0, 1, 3, 2, 4, 5]}))
        new_nodes.append(Node(r2, "reshape", (tr,), (),
                              {"shape": [b_, oh, ow, kh * kw * cin], "batch_leading": True}))
        new_nodes.append(Node(n.name, "dense", (r2,), n.params, {}))
        w2d = w.reshape(kh * kw * cin, cout)
        new_params[n.params[0]] = w2d
        new_specs[n.params[0]] = TensorSpec(w2d.shape, str(w2d.dtype))
        changed = True
    if not changed:
        return graph, dict(params)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              new_specs, dict(graph.meta))
    g.validate()
    return g, new_params


def pack_phase_stem(graph: Graph, params) -> tuple[Graph, dict]:
    """W-axis pair packing of the strided small-cin stems: each int8
    qconv2d with a fused input quantize (``s_in``), strides (2, 2), cin <= 4,
    a square kernel and SAME or VALID padding becomes a ``wpack2`` node.
    Two consecutive W-pixels go into the channels (W' = W / 2, cin' =
    2 * cin), so the W stride is one packed pixel and the conv is one
    stride-(2, 1) conv of the (k, ceil(k / 2), 2 * cin, cout) weight
    ``{name}.wpack``: tap j of output ox is packed pixel ox + j // 2,
    in-pair pixel j % 2. Attrs ``pack_kshape``, ``pack_pad_w`` (W zero pads
    before packing), ``pack_pad_h``, ``pack_ow``, ``pack_oh``. Exact: the
    same products, summed in another order.

    Runs after ``fuse_stem_quantize``. The reference's pass swallows a
    failure of ``activation_shapes`` and returns the graph unchanged; this
    one raises. Its right pad is negative for an even kernel with VALID
    padding and an odd width, as the reference's is (the executor then
    raises, as the reference's ``jnp.pad`` does); no stem of the zoo has
    one."""
    shapes = activation_shapes(graph, params)
    new_nodes: list[Node] = []
    new_params = dict(params)
    new_specs = dict(graph.params)
    changed = False
    for n in graph.nodes:
        pad = n.attrs.get("padding", "SAME")
        if not (n.op == "qconv2d" and "s_in" in n.attrs and n.attrs.get("wfmt") == "int8"
                and tuple(n.attrs.get("strides", [1, 1])) == (2, 2)
                and n.attrs.get("groups", 1) == 1):
            new_nodes.append(n)
            continue
        kh, kw, cin, cout = n.attrs["kshape"]
        xshape = shapes.get(n.inputs[0])
        if xshape is None or cin > 4 or kh != kw or pad not in ("SAME", "VALID"):
            new_nodes.append(n)
            continue
        _, h, w, _ = xshape
        if pad == "SAME":
            ow = -(-w // 2)
            lo_w = max(0, (ow - 1) * 2 + kw - w) // 2
            oh = -(-h // 2)
            tot_h = max(0, (oh - 1) * 2 + kh - h)
            lo_h, hi_h = tot_h // 2, tot_h - tot_h // 2
        else:
            ow = (w - kw) // 2 + 1
            oh = (h - kh) // 2 + 1
            lo_w = lo_h = hi_h = 0
        t_w = (kw + 1) // 2
        wq = np.asarray(params[n.params[0]])
        wp = np.zeros((kh, t_w, 2 * cin, cout), np.int8)
        for j in range(kw):
            b_, dw = divmod(j, 2)
            wp[:, b_, dw * cin:(dw + 1) * cin, :] = wq[:, j, :, :]
        wpad = 2 * (ow - 1 + t_w)
        names = (f"{n.name}.wpack",) + tuple(n.params[1:])
        new_params[names[0]] = wp
        new_specs[names[0]] = TensorSpec(wp.shape, "int8")
        new_params.pop(n.params[0], None)
        new_specs.pop(n.params[0], None)
        attrs = dict(n.attrs, wfmt="wpack2", pack_kshape=list(wp.shape),
                     pack_pad_w=[lo_w, wpad - w - lo_w], pack_pad_h=[lo_h, hi_h],
                     pack_ow=ow, pack_oh=oh)
        new_nodes.append(Node(n.name, "qconv2d", n.inputs, names, attrs))
        changed = True
    if not changed:
        return graph, dict(params)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              new_specs, dict(graph.meta))
    g.validate()
    return g, new_params


_LAYOUT = {"reshape", "transpose", "flatten"}


def hoist_input_quantize(graph: Graph, params) -> tuple[Graph, dict]:
    """Move each quantize node up through the single-consumer reshape,
    transpose and flatten nodes above it, so that the layout copies move
    int8 bytes instead of f32 (exact: the quantize is elementwise and these
    ops permute). The patchified ViT stem's transpose then runs on the int8
    image. Nodes are re-emitted in the reference pass's order: each sweep
    over the remaining nodes emits every node whose inputs are ready."""
    node_map = {n.name: n for n in graph.nodes}
    consumers: dict[str, list[str]] = {}
    for n in graph.nodes:
        for i in n.inputs:
            consumers.setdefault(i, []).append(n.name)
    outputs = set(graph.outputs)
    moved = False
    for q in [n for n in graph.nodes if n.op == "quantize"]:
        chain: list[Node] = []
        cur = q.inputs[0]
        while (cur in node_map and node_map[cur].op in _LAYOUT
               and len(consumers.get(cur, [])) == 1 and cur not in outputs):
            chain.append(node_map[cur])
            cur = node_map[cur].inputs[0]
        if not chain:
            continue
        # q reads the chain's source, the chain's top reads q, and q's
        # consumers read the chain's bottom
        top = chain[-1]
        for cname in consumers.get(q.name, []):
            c = node_map[cname]
            node_map[cname] = Node(c.name, c.op, tuple(chain[0].name if i == q.name else i
                                                       for i in c.inputs),
                                   c.params, c.attrs)
        node_map[q.name] = Node(q.name, "quantize", (cur,), (), dict(q.attrs))
        node_map[top.name] = Node(top.name, top.op, (q.name,), top.params, dict(top.attrs))
        moved = True
    if not moved:
        return graph, dict(params)
    order: list[Node] = []
    emitted: set[str] = set(graph.inputs)
    remaining = {n.name: node_map[n.name] for n in graph.nodes}
    while remaining:
        progress = False
        for name in list(remaining):
            n = remaining[name]
            if all(i in emitted or i not in remaining for i in n.inputs):
                order.append(n)
                emitted.add(name)
                del remaining[name]
                progress = True
        if not progress:  # a cycle: leave the graph as it was, as the reference does
            return graph, dict(params)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, order,
              dict(graph.params), dict(graph.meta))
    g.validate()
    return g, dict(params)


# ops between an lrn and its quantize that commute with the quantize: each
# is monotone or a permutation, as round and clip are monotone
_COMMUTING = {"maxpool", "reshape", "flatten", "identity", "dropout", "transpose", "pad"}


def fuse_lrn_quantize(graph: Graph, params) -> tuple[Graph, dict]:
    """Fold dequantize -> lrn -> (commuting ops) -> quantize into a ``qlrn``
    node (int8 in, int8 out), followed by the commuting ops on int8.

    Applies when the dequantize, the lrn and each op of the chain have one
    consumer and none is a graph output. The qlrn takes the quantize's
    name, or ``<lrn>__qlrn`` when a chain follows it (the chain's last op
    then takes the quantize's name). A SAME maxpool window made only of
    padding would give -127 unfused and -128 fused; no pool of the zoo has
    one.
    """
    consumers = graph.consumers()
    outputs = set(graph.outputs)
    rewrites: dict[str, tuple] = {}  # quantize name -> (dq, lrn, chain, q)
    dead: set[str] = set()
    for dq in graph.nodes:
        if dq.op != "dequantize" or dq.name in outputs:
            continue
        cons = consumers.get(dq.name, [])
        if len(cons) != 1 or cons[0].op != "lrn" or cons[0].name in outputs:
            continue
        lrn = cons[0]
        chain: list[Node] = []
        cur, q = lrn, None
        while True:
            nxt = consumers.get(cur.name, [])
            if len(nxt) != 1 or cur.name in outputs:
                break
            if nxt[0].op == "quantize":
                q = nxt[0]
                break
            if nxt[0].op not in _COMMUTING:
                break
            cur = nxt[0]
            chain.append(cur)
        if q is None:
            continue
        rewrites[q.name] = (dq, lrn, chain, q)
        dead.update((dq.name, lrn.name))
        dead.update(n.name for n in chain)
    if not rewrites:
        return graph, dict(params)

    new_nodes: list[Node] = []
    for n in graph.nodes:
        if n.name in dead:
            continue
        if n.name not in rewrites:
            new_nodes.append(n)
            continue
        dq, lrn, chain, q = rewrites[n.name]
        attrs = {"radius": lrn.attrs.get("radius", 2), "alpha": lrn.attrs.get("alpha", 1e-4),
                 "beta": lrn.attrs.get("beta", 0.75), "bias": lrn.attrs.get("bias", 1.0),
                 "s_in": float(dq.attrs["scale"]), "s_out": float(q.attrs["scale"])}
        prev = f"{lrn.name}__qlrn" if chain else q.name
        new_nodes.append(Node(prev, "qlrn", (dq.inputs[0],), (), attrs))
        for i, p in enumerate(chain):
            name = q.name if i == len(chain) - 1 else p.name
            new_nodes.append(Node(name, p.op, (prev,), p.params, dict(p.attrs)))
            prev = name
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              dict(graph.params), dict(graph.meta))
    g.validate()
    return g, dict(params)


MIXED_MERGE_MIN_H = 20  # the reference's gate for padding 1x1s into a 3x3


def merge_sibling_1x1(graph: Graph, params) -> tuple[Graph, dict]:
    """Merge the int8 qconv2d siblings that read one input with the same
    relu into one wide conv plus ``slice_c`` nodes (GoogLeNet's inception
    heads: the 1x1, 3x3-reduce and 5x5-reduce convs).

    Exact: each output channel keeps its own weights, es and eb. Two or
    more 1x1s merge into a 1x1; 1x1s beside a 3x3 SAME merge into a 3x3
    (the 1x1 weights zero-padded to 3x3, exact under SAME padding: SqueezeNet's
    fire expands) when the input is at least ``MIXED_MERGE_MIN_H`` rows
    high. The merged node is ``<input>__m1x1`` with params ``.wq``, ``.es``,
    ``.eb``; each sibling becomes a ``slice_c`` of its channels under its own
    name. Matches int8 stride-1 ungrouped convs without a fused input
    quantize. Two relu groups on one input would both take the name
    ``<input>__m1x1`` and fail validation, as the reference's pass does.
    """
    shapes = activation_shapes(graph, params)
    groups: dict[tuple, list[Node]] = defaultdict(list)
    for n in graph.nodes:
        k = tuple(n.attrs["kshape"][:2]) if n.op == "qconv2d" else None
        if (k in ((1, 1), (3, 3)) and n.attrs.get("wfmt") == "int8"
                and tuple(n.attrs.get("strides", [1, 1])) == (1, 1)
                and n.attrs.get("groups", 1) == 1 and "s_in" not in n.attrs
                and (k == (1, 1) or n.attrs.get("padding", "SAME") == "SAME")):
            groups[(n.inputs[0], bool(n.attrs.get("relu")))].append(n)

    merges: dict[tuple, tuple[list[Node], int]] = {}
    for key, sibs in groups.items():
        ones = [s for s in sibs if tuple(s.attrs["kshape"][:2]) == (1, 1)]
        threes = [s for s in sibs if tuple(s.attrs["kshape"][:2]) == (3, 3)]
        if ones and threes and shapes[key[0]][1] >= MIXED_MERGE_MIN_H:
            merges[key] = (ones + threes, 3)
        elif len(ones) >= 2:
            merges[key] = (ones, 1)
    if not merges:
        return graph, dict(params)

    new_params = dict(params)
    new_specs = dict(graph.params)
    replaced: dict[str, tuple[str, int, int]] = {}  # sibling -> (merged, lo, hi)
    merged_nodes: dict[str, Node] = {}  # first sibling -> merged node
    for (src, relu), (sibs, km) in merges.items():
        mname = f"{src}__m1x1"
        ws, ess, ebs, lo = [], [], [], 0
        for s in sibs:
            kh, kw, cin, cout = s.attrs["kshape"]
            w = np.asarray(new_params[s.params[0]]).reshape(kh, kw, cin, cout)
            if kh != km:
                p = (km - kh) // 2
                w = np.pad(w, ((p, p), (p, p), (0, 0), (0, 0)))
            ws.append(w)
            ess.append(np.asarray(new_params[s.params[1]]))
            ebs.append(np.asarray(new_params[s.params[2]]))
            replaced[s.name] = (mname, lo, lo + cout)
            lo += cout
        pn = (f"{mname}.wq", f"{mname}.es", f"{mname}.eb")
        new_params[pn[0]] = np.concatenate(ws, axis=3).astype(np.int8)
        new_params[pn[1]] = np.concatenate(ess).astype(np.float32)
        new_params[pn[2]] = np.concatenate(ebs).astype(np.float32)
        for nm in pn:
            new_specs[nm] = TensorSpec(new_params[nm].shape, str(new_params[nm].dtype))
        for s in sibs:
            for old in s.params:
                new_params.pop(old, None)
                new_specs.pop(old, None)
        first = sibs[0]
        attrs = {"relu": relu, "wfmt": "int8", "in_scale": first.attrs.get("in_scale"),
                 "out_scales": [s.attrs.get("out_scale") for s in sibs],
                 "strides": [1, 1], "padding": "SAME", "groups": 1,
                 "kshape": [km, km, ws[0].shape[2], lo]}
        merged_nodes[first.name] = Node(mname, "qconv2d", (src,), pn, attrs)
    new_nodes: list[Node] = []
    for n in graph.nodes:
        if n.name not in replaced:
            new_nodes.append(n)
            continue
        if n.name in merged_nodes:
            new_nodes.append(merged_nodes[n.name])
        mname, lo, hi = replaced[n.name]
        new_nodes.append(Node(n.name, "slice_c", (mname,), (), {"lo": lo, "hi": hi}))
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              new_specs, dict(graph.meta))
    g.validate()
    return g, new_params


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


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def space_to_depth_stem(graph: Graph, params) -> tuple[Graph, dict]:
    """Rewrite the first qconv2d, when it is an int8 odd k x k stride-2 SAME
    ungrouped stem on cin <= 8, into pad -> space_to_depth -> a VALID
    stride-1 conv over 4 * cin channels with the (k + 1) / 2-square weight:
    out[oy, ox] = sum s2d(xp)[oy + a, ox + b, (dy, dx, c)] * w[2a + dy,
    2b + dx, c], with the kernel zero-padded to an even size. The pads are
    TF-SAME plus one row or column where the padded extent is odd. When the
    first conv does not match, it logs a warning and changes nothing (the
    ``wpack2`` stem after ``pack_phase_stem``, SqueezeNet's VALID stem).

    Placement: before a single-consumer ``quantize`` that feeds the stem
    (pad and space_to_depth on f32, then the quantize); otherwise on the
    stem's own input, the fallback. Behind the Engine ``fuse_stem_quantize``
    has already deleted the quantize, so the fallback pads and rearranges
    the raw f32 image and the conv keeps its ``s_in``."""
    stem = None
    for n in graph.nodes:
        if n.op == "qconv2d":
            kh, kw, cin, cout = n.attrs["kshape"]
            sh, sw = n.attrs.get("strides", [1, 1])
            if (sh == sw == 2 and kh == kw and kh % 2 == 1 and kh > 1 and cin <= 8
                    and n.attrs.get("groups", 1) == 1
                    and n.attrs.get("padding", "SAME") == "SAME"
                    and n.attrs.get("wfmt") == "int8"):
                stem = n
            else:
                log.warning("space_to_depth_stem: first conv %s does not match the stem "
                            "pattern (wfmt=%s k=%dx%d s=%dx%d cin=%d); rewrite skipped",
                            n.name, n.attrs.get("wfmt"), kh, kw, sh, sw, cin)
            break
    if stem is None:
        return graph, dict(params)

    kh, kw, cin, cout = stem.attrs["kshape"]
    xs = activation_shapes(graph, params)[stem.inputs[0]]
    if len(xs) != 4:
        log.warning("space_to_depth_stem: stem input %s is not 4D (%s); rewrite skipped",
                    stem.inputs[0], xs)
        return graph, dict(params)
    h, w = xs[1], xs[2]
    ph0, ph1 = _same_pads(h, kh, 2)
    pw0, pw1 = _same_pads(w, kw, 2)
    ph1 += (h + ph0 + ph1) % 2
    pw1 += (w + pw0 + pw1) % 2

    w_q = np.asarray(params[stem.params[0]])
    ke = kh + kh % 2
    wpad = np.zeros((ke, ke, cin, cout), w_q.dtype)
    wpad[:kh, :kw] = w_q
    # (2a + dy, 2b + dx, c, o) -> (a, b, (dy, dx, c), o)
    w4 = (wpad.reshape(ke // 2, 2, ke // 2, 2, cin, cout).transpose(0, 2, 1, 3, 4, 5)
          .reshape(ke // 2, ke // 2, 4 * cin, cout))
    new_params = dict(params)
    new_params[stem.params[0]] = w4
    new_specs = dict(graph.params)
    new_specs[stem.params[0]] = TensorSpec(w4.shape, str(w4.dtype))

    quant = None
    for n in graph.nodes:
        if n.name == stem.inputs[0] and n.op == "quantize":
            if len([m for m in graph.nodes if n.name in m.inputs]) == 1:
                quant = n
            break

    pad_name, s2d_name = f"{stem.name}__s2d_pad", f"{stem.name}__s2d"
    pads_attr = {"pads": [[0, 0], [ph0, ph1], [pw0, pw1], [0, 0]]}
    attrs = dict(stem.attrs, strides=[1, 1], padding="VALID",
                 kshape=[ke // 2, ke // 2, 4 * cin, cout])
    new_nodes: list[Node] = []
    for n in graph.nodes:
        if quant is not None and n.name == quant.name:
            # f32 domain: pad and space_to_depth feed the quantize itself
            new_nodes.append(Node(pad_name, "pad", (quant.inputs[0],), (), pads_attr))
            new_nodes.append(Node(s2d_name, "space_to_depth", (pad_name,), (), {"block": 2}))
            new_nodes.append(Node(quant.name, quant.op, (s2d_name,), quant.params,
                                  dict(quant.attrs)))
        elif n.name != stem.name:
            new_nodes.append(n)
        elif quant is not None:
            new_nodes.append(Node(stem.name, stem.op, stem.inputs, stem.params, attrs))
        else:
            # fallback: on the stem's own input
            new_nodes.append(Node(pad_name, "pad", (stem.inputs[0],), (), pads_attr))
            new_nodes.append(Node(s2d_name, "space_to_depth", (pad_name,), (), {"block": 2}))
            new_nodes.append(Node(stem.name, stem.op, (s2d_name,), stem.params, attrs))
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              new_specs, dict(graph.meta))
    g.validate()
    return g, new_params
