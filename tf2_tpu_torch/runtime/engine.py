"""Runtime Engine: loads a quantized graph and its params onto a device,
applies the load-time passes and runs the graph eagerly, layer by layer,
each conv and dense layer and each LRN in one of the CUDA kernels."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..graph.execute import execute
from ..graph.ir import Graph, Node, TensorSpec
from ..graph.optimize import (fuse_bottleneck_chains, fuse_lrn_quantize,
                              fuse_stem_quantize, merge_sibling_1x1)
from ..kernels.qconv import covers
from ..transform import potq


def _decode_pot4(graph: Graph, params, names: set[str]):
    """Decode, once at load, the 4-bit PoT codes of the named pot4 qconv2d
    and qdense nodes: each gets int8 weights (``.wq``) in place of its
    packed codes."""
    new_nodes, new_params = [], dict(params)
    new_specs = dict(graph.params)
    changed = False
    for n in graph.nodes:
        if n.name in names:
            kflat = int(np.prod(n.attrs["kshape"][:-1]))
            codes = potq.unpack_codes_np(np.asarray(params[n.params[0]]), kflat)
            wq = potq.pot_decode_np(codes).reshape(n.attrs["kshape"])
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


def _predecode_fallback_weights(graph: Graph, params):
    """Decode the pot4 qconv2d and qdense nodes that the kernels cannot
    take packed. A conv keeps its packed codes when it is ungrouped with
    equal strides of 1 or 2 and an even K; a dense when its K is even."""
    names = set()
    for n in graph.nodes:
        if n.op in ("qconv2d", "qdense") and n.attrs.get("wfmt") == "pot4":
            keep = n.op == "qdense" or covers(n.attrs["kshape"],
                                               n.attrs.get("strides", [1, 1]),
                                               n.attrs.get("groups", 1))
            if not (keep and np.prod(n.attrs["kshape"][:-1]) % 2 == 0):
                names.add(n.name)
    return _decode_pot4(graph, params, names)


def _on_int8(graph: Graph, params, rewrite, taken):
    """A pass that matches int8 convs only, on the port's graph, where
    predecode keeps every conv the kernels take as pot4: first decode
    exactly the convs the pass takes when every pot4 conv is decoded
    (``taken(trial graph)`` names them), then run it. The other convs keep
    their packed codes."""
    pot4 = {n.name for n in graph.nodes
            if n.op == "qconv2d" and n.attrs.get("wfmt") == "pot4"}
    trial, _ = rewrite(*_decode_pot4(graph, params, pot4))
    return rewrite(*_decode_pot4(graph, params, pot4 & taken(trial)))


def _merge_1x1(graph: Graph, params):
    """``merge_sibling_1x1``: a merged sibling becomes a ``slice_c``."""
    return _on_int8(graph, params, merge_sibling_1x1,
                    lambda g: {n.name for n in g.nodes if n.op == "slice_c"})


def _fuse_chains(graph: Graph, params):
    """``fuse_bottleneck_chains``: a conv in a chain leaves the graph."""
    names = {n.name for n in graph.nodes}
    return _on_int8(graph, params, fuse_bottleneck_chains,
                    lambda g: names - {n.name for n in g.nodes})


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

    The load passes: predecode, ``fuse_stem_quantize``, ``fuse_lrn_quantize``,
    then the optional ones. ``merge_1x1=True`` merges sibling int8 convs on
    one input into one wide conv and channel slices (``graph/optimize.
    merge_sibling_1x1``; the merged convs get int8 weights); off by default
    until a measurement on the card decides it (the reference turns it on
    because of a TPU measurement). ``block_fusion=True`` rewrites runs of
    stride-1 bottleneck blocks into ``qblockchain`` nodes, each run by the
    chain kernel (``kernels/qblocks.py``) with int8 weights. Off by
    default, as in the reference.
    """

    def __init__(self, graph: Graph, params: Mapping[str, np.ndarray],
                 device: str | torch.device = "cuda", block_fusion: bool = False,
                 merge_1x1: bool = False):
        self.device = _resolve_device(device)
        graph.validate()
        graph, params = _predecode_fallback_weights(graph, params)
        graph, params = fuse_stem_quantize(graph, params)
        graph, params = fuse_lrn_quantize(graph, params)
        if merge_1x1:
            graph, params = _merge_1x1(graph, params)
        if block_fusion:
            graph, params = _fuse_chains(graph, params)
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
