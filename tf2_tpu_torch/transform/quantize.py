"""Graph quantizer: rewrites a BN-folded FP32 IR graph into a fused int8
graph.

Produces fused ``qconv2d``/``qdense``/``qadd`` nodes that carry 4-bit
packed PoT codes (or per-channel int8 for the first and last layers) plus
precomputed requant vectors:

    acc_i32 = conv_int8(x_q, decode(codes))
    y_q     = clip(round(acc_i32 * eff_scale_c + eff_bias_c))      # epilogue
    eff_scale_c = s_in * s_w_c / s_out ;  eff_bias_c = b_c / s_out

Activations stay int8 through conv/pool/add/concat/LRN chains and, in a
transformer, through attention (``qattention_core``) and, with
``QuantSpec.int8_residual``, layer norm, GELU, bias adds and the class
token; ops with no integer semantics run fp32 behind dequantize nodes. With
``QuantSpec.fold_residual`` a residual add whose other input is a
single-consumer qdense without relu folds into that qdense's epilogue.
These are the rewrites of ``tf2_tpu.transform.quantize``; each emits the
reference's nodes and params.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from ..graph.ir import Graph, Node, TensorSpec
from . import potq

# ops that pass int8 through unchanged (same scale)
_PASSTHROUGH = {"maxpool", "reshape", "flatten", "identity", "dropout",
                "transpose", "pad", "take_token"}


@dataclasses.dataclass
class QuantSpec:
    """Per-model quantization policy."""
    weight_bits: int = 4              # 4 => PoT codes; 8 => linear int8
    first_last_w8: bool = True        # keep first/last layers at W8
    act_estimator: str = "percentile" # calibrate's estimator (pipeline.py)
    pot_candidates: int = 33
    bias_correct: bool = True         # fold the mean quantization error of
                                      # each conv/dense into its eb
                                      # (transform/bias_correct.py)
    int8_residual: bool = True        # layer_norm, gelu, bias_add and the
                                      # class token on int8 (qlayernorm,
                                      # qgelu, qbias_add) instead of f32
                                      # behind dequantize/quantize
    fold_residual: bool = True        # fold a residual add into the qdense
                                      # epilogue of its other input
    equalize_concat: bool = True      # put every single-consumer concat
                                      # input on the concat's scale, so the
                                      # qconcat is a byte copy


@dataclasses.dataclass
class QuantizedArtifact:
    graph: Graph
    params: dict[str, np.ndarray]

    def size_bytes(self) -> int:
        return sum(int(v.size) * v.dtype.itemsize for v in self.params.values())


def _fit_weight(w: np.ndarray, bits: int, spec: QuantSpec):
    """w: (K, C). Returns (q int8, w_scale (C,), packed codes or None)."""
    if bits == 4:
        q, s = potq.fit_pot(w, n_candidates=spec.pot_candidates)
        return q, s, potq.pack_codes(potq.pot_encode_from_int8(q))
    q, s = potq.fit_int8(w)
    return q, s, None


def _fold_residual(node, graph, consumers, val, new_nodes, new_params, candidates,
                   out_name: str, s_out: float, has_relu: bool) -> bool:
    """Fold the add ``node`` into the epilogue of one of its producers: the
    first candidate (original input, residual's new value, residual's
    scale) whose producer is a single-consumer qdense without relu and not
    a graph output. That qdense's es and eb are requantized straight onto
    the add's grid (the ratio of the scales in f32), it takes the residual
    as a second input with ``radd_scale`` = s_r / s_out, and it takes the
    add's name and relu. Returns whether it folded."""
    for d_orig, r_new, s_r in candidates:
        nv, s_mid = val[d_orig]
        if s_mid is None or d_orig in graph.outputs or len(consumers.get(d_orig, [])) != 1:
            continue
        idx = next((i for i in range(len(new_nodes) - 1, -1, -1)
                    if new_nodes[i].name == nv), None)
        if idx is None or new_nodes[idx].op != "qdense":
            continue
        cand = new_nodes[idx]
        if cand.attrs.get("relu"):
            continue  # relu(d) + r is not relu(d + r)
        ratio = np.float32(s_mid / s_out)
        for p in cand.params[1:3]:
            new_params[p] = np.asarray(new_params[p] * ratio, np.float32)
        attrs = dict(cand.attrs, out_scale=s_out, radd_scale=float(s_r / s_out),
                     relu=has_relu)
        new_nodes[idx] = Node(out_name, "qdense", (cand.inputs[0], r_new), cand.params, attrs)
        val[out_name] = (out_name, s_out)
        val[d_orig] = (out_name, s_out)
        return True
    return False


def quantize_graph(graph: Graph, params: Mapping[str, np.ndarray],
                   act_scales: Mapping[str, float],
                   spec: QuantSpec | None = None) -> QuantizedArtifact:
    """Rewrite ``graph`` (BN already folded) into a quantized graph.
    ``act_scales`` maps every float value name the rewrite touches to its
    activation scale."""
    spec = spec or QuantSpec()
    graph.validate()
    consumers = graph.consumers()
    # with ``equalize_concat`` every single-consumer concat input goes on
    # the concat's own scale: the branch producer's epilogue then writes
    # int8 on the concat's grid and the qconcat is a byte copy
    act_scales = dict(act_scales)
    for node in graph.nodes:
        if not spec.equalize_concat or node.op != "concat" or node.name not in act_scales:
            continue
        for i in node.inputs:
            if i in act_scales and len(consumers.get(i, [])) == 1:
                act_scales[i] = act_scales[node.name]

    # "first layer" = first conv/dense on any path from a graph input,
    # tracing through layout/passthrough ops
    from_input = set(graph.inputs)
    for n in graph.nodes:
        if n.op in _PASSTHROUGH and n.inputs[0] in from_input:
            from_input.add(n.name)
    first_names = {n.name for n in graph.nodes
                   if n.op in ("conv2d", "dense") and
                   any(i in from_input for i in n.inputs)}
    last_name = next((n.name for n in reversed(graph.nodes)
                      if n.op in ("conv2d", "dense")), None)

    new_nodes: list[Node] = []
    new_params: dict[str, np.ndarray] = {}
    new_specs: dict[str, TensorSpec] = {}
    # value name (original graph) -> (value name in new graph, scale or None)
    val: dict[str, tuple[str, float | None]] = {i: (i, None) for i in graph.inputs}
    qcache: dict[str, str] = {}   # fp value -> inserted quantize node name
    dqcache: dict[str, str] = {}  # q8 value -> inserted dequantize node name
    fused: set[str] = set()       # relu nodes folded into their producer

    def add_param(name: str, arr: np.ndarray) -> str:
        new_params[name] = arr
        new_specs[name] = TensorSpec(tuple(arr.shape), str(arr.dtype))
        return name

    def get_q8(orig: str) -> tuple[str, float]:
        nv, s = val[orig]
        if s is not None:
            return nv, s
        if orig in qcache:
            return qcache[orig], act_scales.get(orig)
        scale = float(act_scales[orig])
        qname = f"{orig}__q"
        new_nodes.append(Node(qname, "quantize", (nv,), (), {"scale": scale}))
        qcache[orig] = qname
        return qname, scale

    def get_fp(orig: str) -> str:
        nv, s = val[orig]
        if s is None:
            return nv
        if orig not in dqcache:
            dqname = f"{orig}__dq"
            new_nodes.append(Node(dqname, "dequantize", (nv,), (), {"scale": s}))
            dqcache[orig] = dqname
        return dqcache[orig]

    def relu_fusion(node: Node) -> tuple[bool, str]:
        """A sole relu consumer fuses into the q-node, which takes the
        relu's name so downstream references resolve."""
        cons = consumers.get(node.name, [])
        if len(cons) == 1 and cons[0].op == "relu" and node.name not in graph.outputs:
            fused.add(cons[0].name)
            return True, cons[0].name
        return False, node.name

    for node in graph.nodes:
        if node.name in fused:
            continue

        if node.op in ("conv2d", "dense"):
            has_relu, out_name = relu_fusion(node)
            xin, s_in = get_q8(node.inputs[0])
            s_out = float(act_scales[out_name])
            w = np.asarray(params[node.params[0]], np.float32)
            cout = w.shape[-1]
            bits = spec.weight_bits
            if spec.first_last_w8 and (node.name in first_names or
                                       node.name == last_name):
                bits = 8
            q, w_scale, packed = _fit_weight(w.reshape(-1, cout), bits, spec)
            b = (np.asarray(params[node.params[1]], np.float32)
                 if len(node.params) > 1 else np.zeros((cout,), np.float32))
            attrs = {"relu": has_relu, "in_scale": s_in, "out_scale": s_out,
                     "wbits": bits}
            if packed is not None:
                p = [add_param(f"{out_name}.wp", packed)]
                attrs["wfmt"] = "pot4"
            else:
                p = [add_param(f"{out_name}.wq", q.reshape(w.shape).astype(np.int8))]
                attrs["wfmt"] = "int8"
            p.append(add_param(f"{out_name}.es",
                               np.asarray(s_in * w_scale / s_out, np.float32)))
            p.append(add_param(f"{out_name}.eb", np.asarray(b / s_out, np.float32)))
            if node.op == "conv2d":
                kh, kw, cin_g, _ = w.shape
                attrs.update(strides=node.attrs.get("strides", [1, 1]),
                             padding=node.attrs.get("padding", "SAME"),
                             groups=node.attrs.get("groups", 1),
                             kshape=[kh, kw, cin_g, cout])
                new_nodes.append(Node(out_name, "qconv2d", (xin,), tuple(p), attrs))
            else:
                attrs["kshape"] = [w.shape[0], cout]
                new_nodes.append(Node(out_name, "qdense", (xin,), tuple(p), attrs))
            val[out_name] = (out_name, s_out)
            if node.name != out_name:
                val[node.name] = (out_name, s_out)
            continue

        if node.op == "add":
            _, sa = val[node.inputs[0]]
            _, sb = val[node.inputs[1]]
            if sa is not None and sb is not None:
                has_relu, out_name = relu_fusion(node)
                s_out = float(act_scales[out_name])
                a, _ = get_q8(node.inputs[0])
                bq, _ = get_q8(node.inputs[1])
                if spec.fold_residual and _fold_residual(
                        node, graph, consumers, val, new_nodes, new_params,
                        ((node.inputs[1], a, sa), (node.inputs[0], bq, sb)),
                        out_name, s_out, has_relu):
                    continue
                new_nodes.append(Node(out_name, "qadd", (a, bq), (),
                                      {"sa": sa, "sb": sb, "so": s_out,
                                       "relu": has_relu}))
                val[out_name] = (out_name, s_out)
                continue

        if node.op == "concat":
            states = [val[i] for i in node.inputs]
            if all(s is not None for _, s in states):
                s_out = float(act_scales[node.name])
                new_nodes.append(Node(node.name, "qconcat",
                                      tuple(nv for nv, _ in states), (),
                                      {"in_scales": [s for _, s in states],
                                       "out_scale": s_out,
                                       "axis": node.attrs.get("axis", -1)}))
                val[node.name] = (node.name, s_out)
                continue

        if node.op == "lrn":
            nv, s_in = val[node.inputs[0]]
            if s_in is not None and node.name in act_scales:
                # int8 in, int8 out in one pass (kernels/qlrn.py)
                s_out = float(act_scales[node.name])
                new_nodes.append(Node(node.name, "qlrn", (nv,), (), {
                    "radius": node.attrs.get("radius", 2),
                    "alpha": node.attrs.get("alpha", 1e-4),
                    "beta": node.attrs.get("beta", 0.75),
                    "bias": node.attrs.get("bias", 1.0),
                    "s_in": s_in, "s_out": s_out}))
                val[node.name] = (node.name, s_out)
                continue

        if node.op == "attention_core":
            nv, s_in = val[node.inputs[0]]
            if s_in is not None:
                # int8 QK^T and PV around an f32 softmax; the probabilities
                # on the fixed scale 1/127 (kernels/qattention.py)
                s_out = float(act_scales[node.name])
                new_nodes.append(Node(node.name, "qattention_core", (nv,), (),
                                      {"heads": node.attrs["heads"], "dim": node.attrs["dim"],
                                       "s_in": s_in, "s_out": s_out}))
                val[node.name] = (node.name, s_out)
                continue

        if spec.int8_residual and node.op in ("layer_norm", "gelu", "bias_add"):
            nv, s_in = val[node.inputs[0]]
            if s_in is not None and node.name in act_scales:
                s_out = float(act_scales[node.name])
                attrs = {"s_in": s_in, "s_out": s_out}
                if node.op == "layer_norm":
                    # normalizes the int8 codes (eps rescaled by 1/s_in^2)
                    # and folds the affine into the requant
                    for pname in node.params:
                        add_param(pname, np.asarray(params[pname]))
                    new_nodes.append(Node(node.name, "qlayernorm", (nv,), node.params,
                                          {"eps": node.attrs.get("eps", 1e-6), **attrs}))
                elif node.op == "gelu":
                    new_nodes.append(Node(node.name, "qgelu", (nv,), (), attrs))
                else:
                    # the bias on the output grid: one multiply-add + requant
                    b = np.asarray(params[node.params[0]], np.float32)
                    p = add_param(f"{node.name}.bq", np.asarray(b / s_out, np.float32))
                    new_nodes.append(Node(node.name, "qbias_add", (nv,), (p,), attrs))
                val[node.name] = (node.name, s_out)
                continue

        if spec.int8_residual and node.op == "prepend_token":
            nv, s_in = val[node.inputs[0]]
            if s_in is not None:
                # the class token quantized onto the stream's grid: the op
                # itself is the same on int8
                tok = np.asarray(params[node.params[0]], np.float32)
                p = add_param(f"{node.name}.tq", np.clip(
                    np.round(tok / s_in), -127, 127).astype(np.int8))
                new_nodes.append(Node(node.name, "prepend_token", (nv,), (p,),
                                      dict(node.attrs)))
                val[node.name] = (node.name, s_in)
                continue

        if node.op in _PASSTHROUGH:
            nv, s = val[node.inputs[0]]
            new_nodes.append(Node(node.name, node.op, (nv,), node.params,
                                  dict(node.attrs)))
            val[node.name] = (node.name, s)
            continue

        # default: fp op — dequantize any int8 inputs, keep params
        fp_inputs = tuple(get_fp(i) for i in node.inputs)
        new_nodes.append(Node(node.name, node.op, fp_inputs, node.params,
                              dict(node.attrs)))
        for pname in node.params:
            add_param(pname, np.asarray(params[pname]))
        val[node.name] = (node.name, None)

    outputs = tuple(get_fp(o) for o in graph.outputs)
    g = Graph(graph.name, dict(graph.inputs), outputs, new_nodes, new_specs,
              {**graph.meta, "quantized": True, "weight_bits": spec.weight_bits})
    g.validate()
    return QuantizedArtifact(g, new_params)
