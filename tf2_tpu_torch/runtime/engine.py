"""Runtime Engine: loads a quantized graph and its params onto a device,
applies the load-time passes and runs the graph eagerly, layer by layer,
each conv and dense layer in one of the CUDA kernels."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..graph.execute import execute
from ..graph.ir import Graph, Node, TensorSpec
from ..graph.optimize import fuse_stem_quantize
from ..kernels.qconv import covers
from ..transform import potq


def _predecode_fallback_weights(graph: Graph, params):
    """Decode, once at load, the 4-bit PoT codes of every pot4 qconv2d or
    qdense that the kernels cannot take packed. A conv keeps its packed
    codes when it is ungrouped with equal strides of 1 or 2 and an even K;
    a dense when its K is even. The rest get int8 weights (``.wq``)."""
    new_nodes, new_params = [], dict(params)
    new_specs = dict(graph.params)
    changed = False
    for n in graph.nodes:
        if n.op in ("qconv2d", "qdense") and n.attrs.get("wfmt") == "pot4":
            if n.op == "qconv2d":
                kh, kw, cin_g, cout = n.attrs["kshape"]
                kflat, wshape = kh * kw * cin_g, (kh, kw, cin_g, cout)
                keep = covers(n.attrs["kshape"], n.attrs.get("strides", [1, 1]),
                              n.attrs.get("groups", 1))
            else:
                kflat, cout = n.attrs["kshape"]
                wshape, keep = (kflat, cout), True
            if not (keep and kflat % 2 == 0):
                codes = potq.unpack_codes_np(np.asarray(params[n.params[0]]), kflat)
                wq = potq.pot_decode_np(codes).reshape(wshape)
                wq_name = n.params[0].replace(".wp", ".wq")
                new_params[wq_name] = wq
                new_params.pop(n.params[0], None)
                new_specs[wq_name] = TensorSpec(wq.shape, "int8")
                new_specs.pop(n.params[0], None)
                n = Node(n.name, n.op, n.inputs, (wq_name,) + n.params[1:],
                         dict(n.attrs, wfmt="int8"))
                changed = True
        new_nodes.append(n)
    if not changed:
        return graph, params
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, new_nodes,
              new_specs, dict(graph.meta))
    g.validate()
    return g, new_params


def _resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Engine:
    """Executes a quantized IR graph on one device.

    >>> eng = Engine(graph, params)            # on cuda
    >>> logits = eng.run(image=batch)          # NHWC f32 in, logits out
    """

    def __init__(self, graph: Graph, params: Mapping[str, np.ndarray],
                 device: str | torch.device = "cuda"):
        self.device = _resolve_device(device)
        graph.validate()
        graph, params = _predecode_fallback_weights(graph, params)
        graph, params = fuse_stem_quantize(graph, params)
        self.graph = graph
        self.params = {k: torch.as_tensor(np.asarray(v)).to(self.device)
                       for k, v in params.items()}
        self._fn = execute(graph)

    def _inputs(self, inputs) -> dict[str, torch.Tensor]:
        if not inputs:
            return {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype),
                                   device=self.device)
                    for k, v in self.graph.inputs.items()}
        return {k: torch.as_tensor(v).to(self.device) for k, v in inputs.items()}

    def __call__(self, **inputs):
        """Enqueue one forward; returns before the device finishes."""
        return self._fn(self.params, **self._inputs(inputs))

    def run(self, **inputs):
        out = self(**inputs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def benchmark(self, iters: int = 20, reps: int = 3, **inputs) -> dict:
        """Time ``iters`` back-to-back forwards ``reps`` times with CUDA
        events around each run; report the median run's time per forward."""
        if self.device.type != "cuda":
            raise RuntimeError("Engine.benchmark times the CUDA device")
        x = self._inputs(inputs)
        self._fn(self.params, **x)  # warm-up: kernel build and load
        torch.cuda.synchronize(self.device)
        per_step = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                self._fn(self.params, **x)
            end.record()
            end.synchronize()
            per_step.append(start.elapsed_time(end) / 1e3 / iters)
        dt = float(np.median(per_step))
        batch = next(iter(self.graph.inputs.values())).shape[0]
        return {"latency_s": dt, "batch": batch, "throughput_per_s": batch / dt,
                "per_rep_s": per_step, "iters": iters,
                "device": torch.cuda.get_device_name(self.device)}
