"""Graph quantizer: rewrites a BN-folded FP32 IR graph into a fused int8
graph.

Produces fused ``qconv2d``/``qdense``/``qadd`` nodes that carry 4-bit
packed PoT codes (or per-channel int8 for the first and last layers) plus
precomputed requant vectors:

    acc_i32 = conv_int8(x_q, decode(codes))
    y_q     = clip(round(acc_i32 * eff_scale_c + eff_bias_c))      # epilogue
    eff_scale_c = s_in * s_w_c / s_out ;  eff_bias_c = b_c / s_out

Activations stay int8 through conv/pool/add chains; ops with no integer
semantics run fp32 behind dequantize nodes.

This slice ports the rewrites a CNN of the ResNet family needs. The
rewrites ``tf2_tpu.transform.quantize`` applies to concat, LRN, attention
and transformer ops, and the residual fold into a ``qdense`` epilogue,
raise NotImplementedError here rather than produce a different graph.
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
# ops that tf2_tpu quantizes with rewrites this package does not have yet
_NOT_PORTED = {"concat", "attention_core", "lrn", "layer_norm", "gelu",
               "bias_add", "prepend_token"}


@dataclasses.dataclass
class QuantSpec:
    """Per-model quantization policy."""
    weight_bits: int = 4              # 4 => PoT codes; 8 => linear int8
    first_last_w8: bool = True        # keep first/last layers at W8
    pot_candidates: int = 33


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


def quantize_graph(graph: Graph, params: Mapping[str, np.ndarray],
                   act_scales: Mapping[str, float],
                   spec: QuantSpec | None = None) -> QuantizedArtifact:
    """Rewrite ``graph`` (BN already folded) into a quantized graph.
    ``act_scales`` maps every float value name the rewrite touches to its
    activation scale."""
    spec = spec or QuantSpec()
    graph.validate()
    consumers = graph.consumers()
    for n in graph.nodes:
        if n.op in _NOT_PORTED:
            raise NotImplementedError(
                f"quantizing op {n.op!r} (node {n.name!r}) is not ported")

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
                for d in node.inputs:
                    prod = next((n for n in new_nodes if n.name == val[d][0]), None)
                    if (prod is not None and prod.op == "qdense"
                            and not prod.attrs.get("relu")
                            and d not in graph.outputs
                            and len(consumers.get(d, [])) == 1):
                        raise NotImplementedError(
                            f"folding residual add {node.name!r} into a qdense "
                            "epilogue is not ported")
                has_relu, out_name = relu_fusion(node)
                s_out = float(act_scales[out_name])
                a, _ = get_q8(node.inputs[0])
                bq, _ = get_q8(node.inputs[1])
                new_nodes.append(Node(out_name, "qadd", (a, bq), (),
                                      {"sa": sa, "sb": sb, "so": s_out,
                                       "relu": has_relu}))
                val[out_name] = (out_name, s_out)
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
