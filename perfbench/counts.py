"""Operations and bytes of each node of an artifact's graph (the graph as
written, not the Engine's rewritten one, so a fusion changes no count), and
the least time the device could take for them.

Conv and dense nodes are counted with the arithmetic of the port's
``bench/roofline.analyze`` (frozen here): MACs; bytes = the input once (1
byte an element), the weight (half a byte for 4-bit codes of a conv, 1
byte otherwise), the output once. ``analyze`` counts nothing else; here the
attention core counts its two int8 products (QK^T and PV: 2 T^2 D MACs an
image) and its input and output, and every other node that moves data its
inputs read once and its output written once, by dtype (a ``reshape`` is a
view and moves nothing). A node's bound is the larger of 2 MACs over the
int8 peak and bytes over the memory bandwidth (``peaks.json``)."""
from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).with_name("peaks.json")


def peaks(kind: str) -> dict | None:
    """The datasheet peaks of the card named ``kind``, or None."""
    return json.loads(PEAKS.read_text()).get(kind)


def conv_out_hw(h, w, kh, kw, sh, sw, padding):
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    return (h - kh) // sh + 1, (w - kw) // sw + 1


_INT8_OUT = {"quantize", "qconv2d", "qdense", "qadd", "qattention_core", "qlayernorm",
             "qgelu", "qbias_add", "qconcat", "qlrn"}


def nodes(graph: dict, batch: int) -> list[dict]:
    """[{name, op, macs, bytes}] for every node of ``graph`` at ``batch``."""
    (iname, ispec), = graph["inputs"].items()
    shapes = {iname: (batch, *ispec["shape"][1:])}
    size = {iname: 4}   # bytes an element: the f32 image
    out = []
    for n in graph["nodes"]:
        op, at = n["op"], n["attrs"]
        x = shapes[n["inputs"][0]]
        macs, nbytes = 0, None
        if op == "qconv2d":
            kh, kw, cin_g, cout = at["kshape"]
            sh, sw = at.get("strides", [1, 1])
            oh, ow = conv_out_hw(x[1], x[2], kh, kw, sh, sw, at.get("padding", "SAME"))
            macs = x[0] * oh * ow * cout * kh * kw * cin_g
            w_bytes = kh * kw * cin_g * cout * (0.5 if at.get("wfmt") == "pot4" else 1)
            nbytes = (x[0] * x[1] * x[2] * (cin_g * at.get("groups", 1)) + w_bytes
                      + x[0] * oh * ow * cout)
            t = (x[0], oh, ow, cout)
        elif op == "qdense":
            k, cout = at["kshape"]
            m = math.prod(x[:-1])
            macs = m * k * cout
            nbytes = m * k + k * cout + m * cout
            t = x[:-1] + (cout,)
        elif op == "maxpool":
            wh, ww = at["window"]
            sh, sw = at["strides"]
            oh, ow = conv_out_hw(x[1], x[2], wh, ww, sh, sw, at.get("padding", "VALID"))
            t = (x[0], oh, ow, x[3])
        elif op == "global_avgpool":
            t = (x[0], x[3])
        elif op == "reshape":
            t = (batch, *at["shape"][1:]) if at.get("batch_leading") else tuple(at["shape"])
            nbytes = 0
        elif op == "transpose":
            t = tuple(x[p] for p in at["perm"])
        elif op == "qattention_core":
            b, tt, three_d = x
            macs = 2 * b * tt * tt * (three_d // 3)
            t = (b, tt, three_d // 3)
        else:
            t = x
        if op in _INT8_OUT:
            esize = 1
        elif op in ("dequantize", "global_avgpool"):
            esize = 4
        else:
            esize = size[n["inputs"][0]]
        if nbytes is None:
            nbytes = (sum(math.prod(shapes[i]) * size[i] for i in n["inputs"])
                      + math.prod(t) * esize
                      + sum(math.prod(graph["params"][p]["shape"])
                            * (1 if graph["params"][p]["dtype"] in ("int8", "uint8") else 4)
                            for p in n["params"]))
        shapes[n["name"]], size[n["name"]] = t, esize
        out.append({"name": n["name"], "op": op, "macs": macs, "bytes": nbytes})
    return out


def bound_s(graph: dict, batch: int, peak: dict) -> float:
    """The sum over nodes of max(2 MACs / int8 peak, bytes / bandwidth)."""
    return sum(max(2 * n["macs"] / peak["int8_ops_per_s"], n["bytes"] / peak["hbm_bytes_per_s"])
               for n in nodes(graph, batch))


def ops_per_image(graph: dict) -> float:
    """2 MACs of one image: the convs, the dense layers and the attention
    products."""
    return 2.0 * sum(n["macs"] for n in nodes(graph, 1))
