"""Artifact graphs by family: ``families/<family>.py`` has ``build(cfg,
gen, device)``, which lays out a configuration's quantized graph (the artifact's
nodes, names and attributes, at batch 1) through an ``Emitter``; the
emitter then draws the float weights from the seed on the device, folds
batch norm and fits each layer's weights. The configuration file names its
family, so a new family is a new module here."""
from __future__ import annotations

import importlib
import math

import torch

from .. import quant


class Emitter:
    """Collects nodes and the layers whose weights are drawn later."""

    def __init__(self, name: str, image_shape, cfg: dict):
        self.name = name
        self.cfg = cfg
        self.s = float(cfg["activation_scale"])
        self.nodes: list[dict] = []
        self.layers: list[dict] = []     # weights still to draw and fit
        self.consts: dict[str, torch.Tensor] = {}
        self.inputs = {"image": {"shape": [1, *image_shape], "dtype": "float32"}}

    def node(self, name, op, inputs, params=(), **attrs) -> str:
        self.nodes.append({"name": name, "op": op, "inputs": list(inputs),
                           "params": list(params), "attrs": attrs})
        return name

    def const(self, name: str, value: torch.Tensor) -> str:
        self.consts[name] = value
        return name

    def quantize(self, x: str) -> str:
        return self.node(f"{x}__q", "quantize", [x], scale=self.s)

    def dequantize(self, x: str) -> str:
        return self.node(f"{x}__dq", "dequantize", [x], scale=self.s)

    def layer(self, x: str, name: str, kshape, *, bits: int, relu: bool, bn: bool = False,
              conv: dict | None = None, residual: str | None = None,
              node_name: str | None = None) -> str:
        """A ``qconv2d`` (``conv``: strides, padding, groups) or ``qdense``
        node; its params are named after ``name`` (after ``name_relu`` when
        the relu is fused), the node after ``node_name`` where a residual add
        was folded into it."""
        pname = f"{name}_relu" if relu else name
        out = node_name or pname
        wfmt = "pot4" if bits == 4 else "int8"
        params = [f"{pname}.{'wp' if bits == 4 else 'wq'}", f"{pname}.es", f"{pname}.eb"]
        attrs = {"relu": relu, "in_scale": self.s, "out_scale": self.s, "wbits": bits,
                 "wfmt": wfmt}
        if conv is not None:
            attrs.update(strides=conv["strides"], padding=conv["padding"],
                         groups=conv.get("groups", 1), kshape=list(kshape))
            op = "qconv2d"
        else:
            attrs["kshape"] = list(kshape)
            op = "qdense"
        if residual is not None:
            attrs["radd_scale"] = 1.0
        self.layers.append({"params": params, "kshape": list(kshape), "bits": bits, "bn": bn})
        return self.node(out, op, [x] if residual is None else [x, residual], params, **attrs)

    def _specs(self) -> dict[str, dict]:
        specs = {}
        for layer in self.layers:
            kshape, cout = layer["kshape"], layer["kshape"][-1]
            wp, es, eb = layer["params"]
            if layer["bits"] == 4:
                specs[wp] = {"shape": [-(-math.prod(kshape[:-1]) // 2), cout], "dtype": "uint8"}
            else:
                specs[wp] = {"shape": list(kshape), "dtype": "int8"}
            specs[es] = specs[eb] = {"shape": [cout], "dtype": "float32"}
        for k, v in self.consts.items():
            specs[k] = {"shape": list(v.shape), "dtype": "float32"}
        return specs

    def finish(self, gen: torch.Generator | None, device, outputs: list[str],
               meta: dict) -> tuple[dict, dict[str, torch.Tensor]]:
        """Draw every weight in one call (He-normal), the batch-norm
        statistics in two (variance 0.5 + U[0, 1), mean 0.1 N(0, 1); scale
        1, offset 0), fold, fit. -> (graph dict, {param: tensor}); without a
        generator, the graph alone and no params."""
        graph = {"ir_version": 1, "name": self.name, "inputs": self.inputs,
                 "outputs": outputs, "nodes": self.nodes, "params": self._specs(),
                 "meta": {**meta, "quantized": True}}
        if gen is None:
            return graph, {}
        sizes = [math.prod(layer["kshape"]) for layer in self.layers]
        bn_sizes = [layer["kshape"][-1] if layer["bn"] else 0 for layer in self.layers]
        z = torch.randn(sum(sizes), generator=gen, device=device)
        var = 0.5 + torch.rand(sum(bn_sizes), generator=gen, device=device)
        mean = 0.1 * torch.randn(sum(bn_sizes), generator=gen, device=device)
        eps = float(self.cfg.get("bn_eps", 1e-5))
        params: dict[str, torch.Tensor] = {}
        at = bt = 0
        for layer, n, nb in zip(self.layers, sizes, bn_sizes):
            k = n // layer["kshape"][-1]
            w = z[at:at + n].reshape(k, -1) * math.sqrt(2.0 / k)
            b = torch.zeros(w.shape[1], device=device)
            if layer["bn"]:
                inv = 1.0 / torch.sqrt(var[bt:bt + nb] + eps)
                w = w * inv
                b = (b - mean[bt:bt + nb]) * inv
            at, bt = at + n, bt + nb
            if layer["bits"] == 4:
                q, ws = quant.fit_pot(w, int(self.cfg["pot_candidates"]))
                wparam = quant.pack_pot4(q)
            else:
                q, ws = quant.fit_int8(w, int(self.cfg["int8_candidates"]))
                wparam = q.reshape(layer["kshape"])
            wp, es, eb = layer["params"]
            params[wp] = wparam.contiguous()
            params[es] = (self.s * ws / self.s).to(torch.float32)
            params[eb] = (b / self.s).to(torch.float32)
        params.update(self.consts)
        return graph, params


def build(cfg: dict, gen: torch.Generator | None, device) -> tuple[dict, dict[str, torch.Tensor]]:
    """The configuration's artifact graph (batch 1) and its params drawn
    from ``gen`` (none without it)."""
    return importlib.import_module(f"{__name__}.{cfg['family']}").build(cfg, gen, device)
