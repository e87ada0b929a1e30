"""Runtime Engine: loads a quantized graph and its params onto a device,
applies the load-time passes and runs the graph layer by layer, each conv
and dense layer, each LRN, each attention core, each int8 layer norm and
each int8 GELU on what the plan made at load names for it
(``dispatch.kernel_of``): one of the CUDA kernels, its ``library`` route
(``kernels/autotune.py``) or, where no kernel takes the node, its plain
version on the card. SSD's box decode and candidate sort are plain PyTorch
on the device and its greedy NMS mask a kernel (``kernels/detection.py``),
where the reference's are XLA. ``Engine.build`` captures the whole forward
in one CUDA graph, which later calls replay: the port's counterpart of the
reference's jitted forward (``tf2_tpu/runtime/engine.py:180-196``)."""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..graph.execute import execute
from ..graph.ir import Graph, Node, TensorSpec
from ..graph.optimize import (fuse_bottleneck_chains, fuse_lrn_quantize,
                              fuse_stem_quantize, hoist_input_quantize,
                              merge_sibling_1x1, pack_phase_stem, space_to_depth_stem)
from ..graph.shapes import activation_shapes
from ..kernels import dispatch
from ..kernels.dispatch import Limits
from ..parallel.mesh import (MeshConfig, all_gather_last, batch_bounds, channel_bounds,
                             gather_batch, input_shardings, local_node, tp_shardable)
from ..transform import potq
from . import spans


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


def routes_of(graph: Graph, params, mesh: MeshConfig | None = None) -> dict[str, str]:
    """{node: route} of the qconv2d and qdense nodes whose route
    (``dispatch.route_node`` on its input shape: override, table,
    ``kernel``) is not ``kernel``: resolved once at load, as the
    reference's predecode asks ``route_conv``/``route_dense``. Under a tp
    ``mesh`` a node that computes its slice of the output channels is
    routed at the width it runs (``parallel.mesh.local_node``)."""
    shapes = activation_shapes(graph, params)
    routes = {}
    for n in graph.nodes:
        if n.op in ("qconv2d", "qdense"):
            node = local_node(n, mesh) if mesh and tp_shardable(n, graph, mesh) else n
            r = dispatch.route_node(node, shapes[n.inputs[0]])
            if r != "kernel":
                routes[n.name] = r
    return routes


def _predecode_fallback_weights(graph: Graph, params, routes=None):
    """Decode the pot4 nodes that do not keep their packed codes: those the
    kernels cannot take packed (``dispatch.packed_kernel_takes``) and those
    ``routes`` sends to ``kernel_int8`` or ``library``."""
    routes = routes or {}
    names = {n.name for n in graph.nodes
             if n.op in ("qconv2d", "qdense") and n.attrs.get("wfmt") == "pot4"
             and (n.name in routes or not dispatch.packed_kernel_takes(n))}
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


def _phase_stem(graph: Graph, params):
    """``pack_phase_stem``: a packed stem becomes a ``wpack2`` node."""
    return _on_int8(graph, params, pack_phase_stem,
                    lambda g: {n.name for n in g.nodes if n.attrs.get("wfmt") == "wpack2"})


def _space_to_depth(graph: Graph, params):
    """``space_to_depth_stem``: the rewritten stem reads a ``space_to_depth``
    node named after it."""
    return _on_int8(graph, params, space_to_depth_stem,
                    lambda g: {n.name.removesuffix("__s2d") for n in g.nodes
                               if n.op == "space_to_depth"})


def _fuse_chains(graph: Graph, params):
    """``fuse_bottleneck_chains``: a conv in a chain leaves the graph."""
    names = {n.name for n in graph.nodes}
    return _on_int8(graph, params, fuse_bottleneck_chains,
                    lambda g: names - {n.name for n in g.nodes})


def shard_tp(graph: Graph, params, mesh: MeshConfig):
    """The graph as this rank of a tp mesh runs it: each node that
    ``tp_shardable`` takes gets this rank's slice of its output channels
    (its last-axis params cut, its ``kshape`` narrowed; a folded residual
    input read through a ``slice_c`` of the same channels). -> (graph,
    params, names of the sliced nodes), whose outputs the forward
    all-gathers before any later node reads them."""
    nodes, new_params, specs, sliced = [], dict(params), dict(graph.params), set()
    for n in graph.nodes:
        if not tp_shardable(n, graph, mesh):
            nodes.append(n)
            continue
        lo, hi = channel_bounds(graph.params[n.params[0]].shape[-1], mesh)
        for p in n.params:
            new_params[p] = np.ascontiguousarray(np.asarray(params[p])[..., lo:hi])
            specs[p] = TensorSpec(new_params[p].shape, graph.params[p].dtype)
        n = local_node(n, mesh)
        if n.op == "qdense" and len(n.inputs) == 2:  # the folded residual, per channel
            res = Node(f"{n.name}__tp_residual", "slice_c", (n.inputs[1],), (),
                       {"lo": lo, "hi": hi})
            nodes.append(res)
            n = Node(n.name, n.op, (n.inputs[0], res.name), n.params, n.attrs)
        nodes.append(n)
        sliced.add(n.name)
    g = Graph(graph.name, dict(graph.inputs), graph.outputs, nodes, specs, dict(graph.meta))
    g.validate()
    return g, new_params, frozenset(sliced)


def resolve_device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Engine:
    """Executes a quantized IR graph on one device.

    >>> eng = Engine(graph, params).build()    # on cuda: one CUDA graph
    >>> logits = eng.run(image=batch)          # NHWC f32 in, logits out

    The load passes, with ``predecode=True`` (the default): the routes and
    the weight decode (``_predecode_fallback_weights``), ``fuse_stem_quantize``,
    ``fuse_lrn_quantize``, ``hoist_input_quantize`` (the patchified ViT
    stem's layout copies then move the int8 image), then the optional ones,
    in the reference's order. ``phase_stem=True`` packs pairs of W-pixels of
    each strided small-cin stem into its channels
    (``graph/optimize.pack_phase_stem``: a ``wpack2`` node, one stride-(2, 1)
    conv); off by default (the reference turns it on because of a TPU
    measurement; on the card its stem node is slower than the stem kernel,
    ``PERF.md``). ``merge_1x1=True`` merges sibling int8 convs on one input
    into one wide conv and channel slices (``graph/optimize.merge_sibling_1x1``;
    the merged convs get int8 weights); off by default (the reference
    turns it on because of a TPU measurement; on the card it does not win at
    both batches, ``PERF.md``). ``block_fusion`` (on by default) rewrites
    runs of stride-1 bottleneck blocks into ``qblockchain`` nodes, each run
    by the chain kernel (``kernels/qblocks.py``) with int8 weights, with the
    same outputs; the reference's default is off, the port's is on because
    it wins on the card at batch 64 and 1 (``bench/tune_sweep.py``,
    ``PERF.md``); ``block_fusion=False`` runs each block's convs on their
    own kernels, as the reference's default Engine. ``optimize=True`` rewrites the
    first conv, an odd k x k stride-2 SAME stem, into pad -> space_to_depth
    -> a stride-1 VALID conv (``graph/optimize.space_to_depth_stem``); off
    by default, as in the reference, and a no-op after ``phase_stem=True``,
    whose ``wpack2`` stem it does not match.

    ``predecode=False`` skips what the reference's skips
    (``tf2_tpu/runtime/engine.py:120-150``): the routes, the weight decode
    and the passes inside that block (``phase_stem`` and ``merge_1x1`` are
    then ignored); ``block_fusion`` and ``optimize`` still apply, on the
    graph as the artifact has it. Every node then takes ``kernel``; a pot4
    node the kernels cannot take packed runs plain on the card.

    Each conv and dense node's route is resolved once at load (``routes``:
    those off ``kernel``). The load ends with the plan (``Engine.plan``):
    ``kernels`` names what runs each node, and the executor runs it so.
    Its views: ``plain_nodes`` (no kernel takes them: their plain versions
    on the card, as the reference runs them in XLA), ``stem_nodes`` (on the
    stem kernel, which quantizes the f32 image itself, as the reference's
    stem fusion does), ``library_nodes`` (``torch._int_mm``). On the CPU
    the plan holds the ``library`` nodes alone; every other node is plain.
    The weights of the int8 GEMMs, of the chains and of the stems on the
    stem kernel are then stored as those kernels read them, each once, seen
    through a view of its own shape (``dispatch.prepare_weights``).

    ``mesh`` (``parallel.make_mesh``; the reference's ``mesh`` option,
    ``tf2_tpu/runtime/engine.py:157-167, 204-209``) runs this rank's part
    of the forward. dp: the graph's batch becomes the local batch before
    any route or plan is made; ``shard_inputs`` cuts this rank's rows out
    of a global batch (where dp does not divide it, every rank runs the
    whole batch, as the reference replicates it); a call returns this
    rank's rows and ``gather`` the global output. tp: after the load
    passes, each node that computes its slice of the output channels
    bit-equal to the whole node's (``parallel.mesh.tp_shardable``:
    ungrouped ``qconv2d``, the stems included, and ``qdense``) gets this
    rank's slice of its params (``shard_tp``, before
    ``dispatch.prepare_weights``) and its output is all-gathered
    (``parallel.mesh.all_gather_last``) before the next node; those nodes
    are ``tp_nodes``. Every other node (the chains, layer norm, attention,
    the int8 glue) runs whole on every rank. The plans see the widths each
    node runs. Outputs equal the unmeshed Engine's bit for bit. A tp
    forward calls collectives (under gloo, with host copies), so ``build``
    refuses it on the card and such an Engine runs eager.

    ``donate_inputs=True``: the caller gives each input tensor to the
    Engine and must not use it again. The Engine reads a donated tensor in
    place (as it reads any tensor on its device) and, once the forward is
    queued, frees its storage, unless an output shares it or torch does not
    own it (a tensor over a numpy array); the tensor is then empty, as a
    donated JAX array is deleted. (The reference's
    donated image cannot alias its logits either: its value lies in the
    buffers' lifecycle, ``tf2_tpu/runtime/engine.py:168-179``.) Outputs equal
    those of the Engine without donation.
    """

    @spans.span("engine.init")
    def __init__(self, graph: Graph, params: Mapping[str, np.ndarray],
                 device: str | torch.device = "cuda", predecode: bool = True,
                 block_fusion: bool = True, merge_1x1: bool = False,
                 phase_stem: bool = False, optimize: bool = False,
                 donate_inputs: bool = False, mesh: MeshConfig | None = None):
        self.device = resolve_device(device)
        graph.validate()
        self.mesh = mesh
        self.rows = None   # this rank's rows [lo, hi) of the global batch
        self._in_sh = {}
        if mesh is not None:
            self._in_sh = input_shardings(graph, mesh)
            self.rows = batch_bounds(next(iter(graph.inputs.values())).shape[0], mesh)
            if self.rows is not None:
                graph = graph.with_batch_size(self.rows[1] - self.rows[0])
        routes = {}
        if predecode:
            with spans.span("engine.routes"):
                routes = routes_of(graph, params, mesh)
            with spans.span("engine.decode"):
                graph, params = _predecode_fallback_weights(graph, params, routes)
            passes = (("fuse_stem_quantize", fuse_stem_quantize, True),
                      ("fuse_lrn_quantize", fuse_lrn_quantize, True),
                      ("hoist_input_quantize", hoist_input_quantize, True),
                      ("pack_phase_stem", _phase_stem, phase_stem),
                      ("merge_sibling_1x1", _merge_1x1, merge_1x1),
                      ("fuse_bottleneck_chains", _fuse_chains, block_fusion),
                      ("space_to_depth_stem", _space_to_depth, optimize))
        else:
            passes = (("fuse_bottleneck_chains", fuse_bottleneck_chains, block_fusion),
                      ("space_to_depth_stem", space_to_depth_stem, optimize))
        for name, rewrite, on in passes:
            if on:
                with spans.span(f"engine.pass.{name}"):
                    graph, params = rewrite(graph, params)
        self.tp_nodes = frozenset()
        shapes = None
        if mesh is not None and mesh.tp > 1:
            with spans.span("engine.pass.shard_tp"):
                # every node reads whole inputs (a sliced node's output is
                # gathered): the plans take the shapes of the graph before the cut
                shapes = activation_shapes(graph, params)
                graph, params, self.tp_nodes = shard_tp(graph, params, mesh)
        self.graph = graph
        # a routed node a later pass replaced (a merged or fused conv) takes
        # the route of what replaced it: kernel
        kept = {n.name for n in graph.nodes}
        self.routes = {k: r for k, r in routes.items() if k in kept}
        limits = Limits.of_card() if self.device.type == "cuda" else None
        with spans.span("engine.plan"):
            self.kernels = self.plan(graph, params, limits, shapes, self.routes)
        self.plain_nodes, self.stem_nodes, self.library_nodes = (
            dispatch.nodes_on(self.kernels, k) for k in ("plain", "qstem", "library"))
        with spans.span("engine.weights"):
            self.params = dispatch.prepare_weights(
                graph, {k: torch.as_tensor(np.asarray(v)).to(self.device)
                        for k, v in params.items()},
                self.stem_nodes)
        self._fn = execute(graph, kernels=self.kernels, gather_nodes=self.tp_nodes,
                           gather=lambda t: all_gather_last(mesh, t))
        self._donate = donate_inputs
        self._graph = None        # the captured forward (build)
        self._static_in: dict[str, torch.Tensor] = {}
        self._static_out = None

    @staticmethod
    def plan(graph: Graph, params, limits: Limits | None, shapes=None,
             routes: Mapping[str, str] | None = None) -> dict[str, str]:
        """{node: what runs it}: ``dispatch.kernel_of`` asked once a node, with
        the card's ``limits`` (None: the CPU) and each node's route (``routes``:
        those off ``kernel``), on ``activation_shapes`` unless ``shapes`` are
        given (a tp rank's). Counts the plain nodes (``engine.plain_nodes``)."""
        routes = routes or {}
        if limits is not None and shapes is None:
            shapes = activation_shapes(graph, params)
        kernels = {n.name: k for n in graph.nodes
                   if (k := dispatch.kernel_of(n, shapes and shapes[n.inputs[0]], params, limits,
                                               routes.get(n.name, "kernel"))) is not None}
        if limits is not None:
            spans.count("engine.plain_nodes", sum(k == "plain" for k in kernels.values()))
        return kernels

    def shard_inputs(self, **inputs):
        """This rank's rows of each input of a global batch (by
        ``parallel.mesh.input_shardings``); the inputs as given without a
        mesh or where the batch is replicated."""
        if self.rows is None:
            return inputs
        lo, hi = self.rows
        return {k: v[lo:hi] if self._in_sh.get(k) else v for k, v in inputs.items()}

    def gather(self, out):
        """The global output from this rank's rows (a collective: every rank
        of the mesh calls it); ``out`` as given where the batch is not split
        (no mesh, dp 1 or a replicated batch)."""
        if self.rows is None:
            return out
        if isinstance(out, tuple):
            return tuple(gather_batch(self.mesh, o) for o in out)
        return gather_batch(self.mesh, out)

    def expected_launches(self, expected: dict[str, int], graph: Graph) -> dict[str, int]:
        """What a forward of this Engine launches: ``expected`` (its
        launches with every node on ``kernel``) moved by the routes resolved
        at load. A GEMM node on ``kernel_int8`` launches the int8 GEMM in
        place of the pot4 one, a node on ``library`` no kernel; a k x k conv
        on ``kernel_int8`` stays on its conv kernel. ``graph``: the
        artifact's, which names each node's weight format before the
        decode."""
        if not self.routes:
            return expected
        if graph is None:
            raise RuntimeError(f"{self.graph.name}: routed nodes {sorted(self.routes)} "
                               "and no graph")
        out, src, final = dict(expected), graph.node_map(), self.graph.node_map()
        for name, route in self.routes.items():
            if dispatch.runs_gemm(final[name], "int8"):
                out["qmatmul_" + src[name].attrs["wfmt"]] -= 1
                if route == "kernel_int8":
                    out["qmatmul_int8"] += 1
        return out

    def _inputs(self, inputs) -> dict[str, torch.Tensor]:
        if not inputs:
            return {k: torch.zeros(v.shape, dtype=getattr(torch, v.dtype),
                                   device=self.device)
                    for k, v in self.graph.inputs.items()}
        return {k: torch.as_tensor(v).to(self.device) for k, v in inputs.items()}

    # ---- build: the captured forward ----

    @spans.span("engine.build")
    def build(self, **example_inputs) -> "Engine":
        """Warm up, then capture; returns self. One eager forward on the
        example (or zero) inputs builds the kernels and fills every cache a
        forward reads (launch layouts, plans, device scalars, shared-memory
        attributes); on the card, one CUDA graph of the whole forward is
        then captured over static input buffers, and ``__call__``, ``run``
        and ``benchmark`` replay it. On the CPU ``build`` is the warm-up
        forward alone: nothing is captured. Every model of the zoo captures,
        SSD with its NMS (the keep mask is a kernel, no wait on the host); a
        tp-meshed forward does not (its all-gathers are collectives, under
        gloo through the host): on the card ``build`` raises with the
        reason. A capture that fails raises."""
        if self.device.type == "cuda" and self.tp_nodes:
            raise RuntimeError(f"{self.graph.name}: a tp={self.mesh.tp} forward all-gathers "
                               f"the outputs of {len(self.tp_nodes)} nodes through "
                               "collectives; it runs eager")
        x = self._inputs(example_inputs)
        self._graph = None
        if self.device.type != "cuda":
            with spans.span("engine.build.warmup"):
                self._fn(self.params, **x)
            return self
        static = {k: v.clone() for k, v in x.items()}
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with spans.span("engine.build.warmup"):
            with torch.cuda.stream(stream):  # the warm-up, on the capture's stream
                self._fn(self.params, **static)
            stream.synchronize()
        with spans.span("engine.build.capture"):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                out = self._fn(self.params, **static)
            torch.cuda.current_stream(self.device).wait_stream(stream)
        self._graph, self._static_in, self._static_out = graph, static, out
        return self

    @property
    def built(self) -> bool:
        """Does a call replay a captured forward?"""
        return self._graph is not None

    def _replay(self, x: Mapping[str, torch.Tensor], call: int):
        """Copy ``x`` into the static inputs, replay the captured forward and
        return copies of its outputs, which the next replay does not
        overwrite. The copy and the replay are spans of the call span
        ``call`` (0: each a call of its own)."""
        step = spans.begin("engine.copy_in", call)
        for k, buf in self._static_in.items():
            buf.copy_(x[k])
        spans.end(step)
        step = spans.begin("engine.replay", call)
        self._graph.replay()
        spans.end(step)
        out = self._static_out
        return tuple(o.clone() for o in out) if isinstance(out, tuple) else out.clone()

    def _captured_inputs(self, inputs) -> dict[str, torch.Tensor]:
        """The inputs of a replay, each checked against the built one's
        shape and dtype (none: zeros)."""
        if not inputs:
            return {k: torch.zeros_like(v) for k, v in self._static_in.items()}
        if set(inputs) != set(self._static_in):
            raise ValueError(f"inputs {sorted(inputs)}, built with {sorted(self._static_in)}")
        out = {}
        for k, v in inputs.items():
            t = torch.as_tensor(v)
            buf = self._static_in[k]
            if tuple(t.shape) != tuple(buf.shape) or t.dtype != buf.dtype:
                raise ValueError(f"input {k!r}: {tuple(t.shape)} {t.dtype}, the Engine was "
                                 f"built for {tuple(buf.shape)} {buf.dtype}; build a new one")
            out[k] = t
        return out

    # ---- run ----

    def __call__(self, **inputs):
        """Enqueue one forward (a replay after ``build``); returns before
        the device finishes. Recorded as an ``engine.call`` span
        (``runtime/spans.py``) with two steps: ``engine.copy_in``, the
        inputs into the Engine's (the host waits for the copy), and
        ``engine.replay``, the forward (the eager one where nothing is
        captured)."""
        call = spans.begin("engine.call")
        try:
            if self._graph is not None:
                x = self._captured_inputs(inputs)
                out = self._replay(x, call)
            else:
                step = spans.begin("engine.copy_in", call)
                x = self._inputs(inputs)
                spans.end(step)
                step = spans.begin("engine.replay", call)
                out = self._fn(self.params, **x)
                spans.end(step)
            if self._donate:
                self._drop(inputs, x, out)
        finally:
            spans.end(call)
        return out

    def _drop(self, inputs, x, out) -> None:
        """Free the storage of each donated tensor the Engine was given on
        its device (not a copy it made), unless an output shares it or
        torch does not own it (a tensor over a numpy array)."""
        outs = out if isinstance(out, tuple) else (out,)
        held = {o.untyped_storage().data_ptr() for o in outs}
        for k, v in inputs.items():
            if (isinstance(v, torch.Tensor) and v is x[k] and v.device == self.device
                    and v.untyped_storage().resizable()
                    and v.untyped_storage().data_ptr() not in held):
                v.untyped_storage().resize_(0)

    def eager(self, **inputs):
        """One eager forward, node by node, also after ``build``: the
        launches the captured forward replays (``bench/profile_trace.py``
        joins them). Returns before the device finishes."""
        return self._fn(self.params, **self._inputs(inputs))

    def run(self, **inputs):
        out = self(**inputs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def benchmark(self, iters: int = 20, reps: int = 3, **inputs) -> dict:
        """Time ``iters`` back-to-back forwards ``reps`` times with CUDA
        events around each run; report the median run's time per forward.
        A forward is what ``__call__`` runs on inputs already on the card:
        after ``build`` the copy into the static inputs, the replay and the
        output's copy; before it the eager forward (its first call, which
        builds the kernels, untimed). Donated inputs are not freed here."""
        if self.device.type != "cuda":
            raise RuntimeError("Engine.benchmark times the CUDA device")
        if self._graph is not None:
            x = {k: v.to(self.device) for k, v in self._captured_inputs(inputs).items()}
            step = lambda: self._replay(x, 0)  # noqa: E731
        else:
            x = self._inputs(inputs)
            step = lambda: self._fn(self.params, **x)  # noqa: E731
        step()  # warm-up: kernel build and load
        torch.cuda.synchronize(self.device)
        per_step = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step()
            end.record()
            end.synchronize()
            per_step.append(start.elapsed_time(end) / 1e3 / iters)
        dt = float(np.median(per_step))
        batch = next(iter(self.graph.inputs.values())).shape[0]
        return {"latency_s": dt, "batch": batch, "throughput_per_s": batch / dt,
                "per_rep_s": per_step, "iters": iters, "captured": self._graph is not None,
                "device": torch.cuda.get_device_name(self.device)}
