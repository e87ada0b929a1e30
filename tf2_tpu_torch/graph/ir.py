"""Graph IR — the offline<->online contract of the engine.

A typed, versioned, topologically ordered op graph serialized as JSON, with
parameters carried separately as a flat dict of arrays (see
``transform/export.py``). The JSON is the same one ``tf2_tpu`` writes, so
either package reads the other's artifacts.

Layout is NHWC for activations and HWIO for conv weights throughout.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterable, Mapping

IR_VERSION = 1

# The op vocabulary shared with tf2_tpu. A graph that names any of these
# parses; the executor runs the ones it has implementations for.
OPS = {
    # compute
    "conv2d": "2-D convolution, NHWC x HWIO -> NHWC",
    "dense": "fully-connected: (N, Cin) x (Cin, Cout)",
    "batch_norm": "inference-time BN: scale/offset/mean/var",
    "bias_add": "per-channel bias add",
    # activations / elementwise
    "relu": "max(x, 0)",
    "relu6": "min(max(x, 0), 6)",
    "sigmoid": "logistic",
    "gelu": "gaussian error linear unit",
    "add": "elementwise add (residual)",
    "mul": "elementwise multiply",
    "layer_scale": "per-channel multiply by a learned vector (ConvNeXt's gamma)",
    # pooling / shape
    "maxpool": "window max pool",
    "avgpool": "window average pool",
    "global_avgpool": "mean over H,W",
    "lrn": "local response normalization (AlexNet/GoogLeNet era)",
    "concat": "concatenate along axis",
    "reshape": "static reshape",
    "flatten": "collapse all but batch dim",
    "transpose": "static permute",
    "pad": "static pad",
    "space_to_depth": "NHWC 2x2 block rearrange: (H,W,C) -> (H/2,W/2,4C)",
    "softmax": "softmax over last axis",
    "dropout": "inference no-op (identity)",
    "identity": "pass-through",
    # attention
    "layer_norm": "layer normalization over last axis",
    "attention": "multi-head self-attention",
    "attention_core": "per-head QK^T/softmax/PV on a packed qkv tensor",
    "qattention_core": "fused int8 attention core (int8 QK^T/PV, fp32 softmax)",
    # detection head
    "box_decode": "SSD prior-box decode",
    "nms": "non-maximum suppression",
    # quantization markers / fused ops (compiler-inserted)
    "quantize": "fp -> int8 with per-tensor scale",
    "dequantize": "int8 -> fp with per-tensor scale",
    "qconv2d": "fused quantized conv+bias+bn+relu+requant",
    "qdense": "fused quantized dense+bias+relu+requant",
    "qadd": "quantized residual add with rescale",
    "qconcat": "int8 concat with per-input rescale to a common scale",
    "qblockchain": "fused run of stride-1 residual bottleneck blocks",
    "qlrn": "fused int8 LRN: dequantize+lrn+requantize in one pass",
    "qgelu": "fused dequantize+gelu+quantize, int8 in/out",
    "qlayernorm": "layer_norm on an int8 stream",
    "qbias_add": "bias/pos-embed add on the int8 grid",
    "slice_c": "static channel slice (last axis)",
    "prepend_token": "prepend a learned (1,1,D) token to a (B,T,D) sequence",
    "take_token": "select one token: (B,T,D) -> (B,D) at attrs['idx']",
}


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple[int, ...]
    dtype: str = "float32"

    def to_json(self) -> dict:
        return {"shape": list(self.shape), "dtype": self.dtype}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "TensorSpec":
        return TensorSpec(tuple(d["shape"]), d["dtype"])


@dataclasses.dataclass
class Node:
    """One op. ``inputs`` name prior values; ``params`` name entries in the
    graph's parameter dict."""

    name: str
    op: str
    inputs: tuple[str, ...]
    params: tuple[str, ...] = ()
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown op {self.op!r} in node {self.name!r}")
        self.inputs = tuple(self.inputs)
        self.params = tuple(self.params)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "op": self.op,
            "inputs": list(self.inputs),
            "params": list(self.params),
            "attrs": {k: list(v) if isinstance(v, tuple) else v
                      for k, v in self.attrs.items()},
        }

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Node":
        return Node(d["name"], d["op"], tuple(d["inputs"]), tuple(d["params"]),
                    dict(d.get("attrs", {})))


@dataclasses.dataclass
class Graph:
    """Topologically ordered op graph. ``params`` holds only metadata; the
    arrays travel separately under the same names."""

    name: str
    inputs: dict[str, TensorSpec]
    outputs: tuple[str, ...]
    nodes: list[Node]
    params: dict[str, TensorSpec] = dataclasses.field(default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> None:
        """Check topological order, name uniqueness, param presence."""
        seen: set[str] = set(self.inputs)
        names: set[str] = set()
        for n in self.nodes:
            if n.name in names:
                raise ValueError(f"duplicate node name {n.name!r}")
            names.add(n.name)
            for i in n.inputs:
                if i not in seen:
                    raise ValueError(
                        f"node {n.name!r} consumes {i!r} before definition")
            for p in n.params:
                if p not in self.params:
                    raise ValueError(f"node {n.name!r} references missing param {p!r}")
            seen.add(n.name)
        for o in self.outputs:
            if o not in seen:
                raise ValueError(f"graph output {o!r} undefined")

    def with_batch_size(self, batch: int) -> "Graph":
        """Same graph at a different leading batch dim. A ``reshape`` whose
        shape[0] is the batch carries ``batch_leading=True``; graphs written
        before that attr existed fall back to comparing shape[0] with the
        old batch."""
        old_batch = next(iter(self.inputs.values())).shape[0]
        new_inputs = {k: TensorSpec((batch,) + v.shape[1:], v.dtype)
                      for k, v in self.inputs.items()}
        nodes = []
        for n in self.nodes:
            attrs = dict(n.attrs)
            if n.op == "reshape" and attrs.get("shape"):
                if "batch_leading" in attrs:
                    rewrite = bool(attrs["batch_leading"])
                else:
                    rewrite = attrs["shape"][0] == old_batch
                if rewrite:
                    attrs["shape"] = [batch] + list(attrs["shape"][1:])
            nodes.append(Node(n.name, n.op, n.inputs, n.params, attrs))
        g = Graph(self.name, new_inputs, self.outputs, nodes,
                  dict(self.params), dict(self.meta))
        g.validate()
        return g

    def node_map(self) -> dict[str, Node]:
        return {n.name: n for n in self.nodes}

    def consumers(self) -> dict[str, list[Node]]:
        """value name -> nodes that consume it."""
        out: dict[str, list[Node]] = {}
        for n in self.nodes:
            for i in n.inputs:
                out.setdefault(i, []).append(n)
        return out

    def to_json(self) -> str:
        return json.dumps({
            "ir_version": IR_VERSION,
            "name": self.name,
            "inputs": {k: v.to_json() for k, v in self.inputs.items()},
            "outputs": list(self.outputs),
            "nodes": [n.to_json() for n in self.nodes],
            "params": {k: v.to_json() for k, v in self.params.items()},
            "meta": self.meta,
        }, indent=1)

    @staticmethod
    def from_json(s: str) -> "Graph":
        d = json.loads(s)
        ver = d.get("ir_version")
        if ver != IR_VERSION:
            raise ValueError(f"IR version mismatch: file={ver} lib={IR_VERSION}")
        g = Graph(
            name=d["name"],
            inputs={k: TensorSpec.from_json(v) for k, v in d["inputs"].items()},
            outputs=tuple(d["outputs"]),
            nodes=[Node.from_json(n) for n in d["nodes"]],
            params={k: TensorSpec.from_json(v) for k, v in d["params"].items()},
            meta=dict(d.get("meta", {})),
        )
        g.validate()
        return g


class GraphBuilder:
    """Fluent builder for model definitions. Every method returns the
    produced value name; parameters are declared with shapes so
    ``init_params`` can materialize them later."""

    def __init__(self, name: str):
        self.name = name
        self._inputs: dict[str, TensorSpec] = {}
        self._nodes: list[Node] = []
        self._params: dict[str, TensorSpec] = {}
        self._counter: dict[str, int] = {}

    def input(self, name: str, shape: Iterable[int], dtype: str = "float32") -> str:
        self._inputs[name] = TensorSpec(tuple(shape), dtype)
        return name

    def _fresh(self, op: str, name: str | None) -> str:
        if name is not None:
            return name
        i = self._counter.get(op, 0)
        self._counter[op] = i + 1
        return f"{op}_{i}"

    def _param(self, name: str, shape: tuple[int, ...], dtype: str = "float32") -> str:
        if name in self._params:
            raise ValueError(f"duplicate param {name!r}")
        self._params[name] = TensorSpec(shape, dtype)
        return name

    def raw(self, op: str, inputs: Iterable[str], params: Iterable[str] = (),
            name: str | None = None, **attrs) -> str:
        n = Node(self._fresh(op, name), op, tuple(inputs), tuple(params), attrs)
        self._nodes.append(n)
        return n.name

    def conv2d(self, x: str, cin: int, cout: int, kernel: int | tuple[int, int],
               stride: int | tuple[int, int] = 1, padding: str | tuple = "SAME",
               groups: int = 1, bias: bool = True, name: str | None = None) -> str:
        kh, kw = (kernel, kernel) if isinstance(kernel, int) else kernel
        sh, sw = (stride, stride) if isinstance(stride, int) else stride
        nm = self._fresh("conv2d", name)
        params = [self._param(f"{nm}.w", (kh, kw, cin // groups, cout))]
        if bias:
            params.append(self._param(f"{nm}.b", (cout,)))
        return self.raw("conv2d", [x], params, name=nm, strides=[sh, sw],
                        padding=padding if isinstance(padding, str) else list(padding),
                        groups=groups)

    def dense(self, x: str, cin: int, cout: int, bias: bool = True,
              name: str | None = None) -> str:
        nm = self._fresh("dense", name)
        params = [self._param(f"{nm}.w", (cin, cout))]
        if bias:
            params.append(self._param(f"{nm}.b", (cout,)))
        return self.raw("dense", [x], params, name=nm)

    def batch_norm(self, x: str, c: int, eps: float = 1e-5,
                   name: str | None = None) -> str:
        nm = self._fresh("batch_norm", name)
        params = [self._param(f"{nm}.{p}", (c,))
                  for p in ("scale", "offset", "mean", "var")]
        return self.raw("batch_norm", [x], params, name=nm, eps=eps)

    def layer_norm(self, x: str, c: int, eps: float = 1e-6,
                   name: str | None = None) -> str:
        nm = self._fresh("layer_norm", name)
        params = [self._param(f"{nm}.scale", (c,)), self._param(f"{nm}.offset", (c,))]
        return self.raw("layer_norm", [x], params, name=nm, eps=eps)

    def layer_scale(self, x: str, c: int, name: str | None = None) -> str:
        """x * gamma over the last axis (ConvNeXt's layer scale); the
        Transform Kit folds it into the conv or dense layer before it
        (``transform/fold.py``)."""
        nm = self._fresh("layer_scale", name)
        return self.raw("layer_scale", [x], [self._param(f"{nm}.gamma", (c,))], name=nm)

    def attention(self, x: str, dim: int, heads: int, name: str | None = None) -> str:
        nm = self._fresh("attention", name)
        params = [
            self._param(f"{nm}.wqkv", (dim, 3 * dim)),
            self._param(f"{nm}.bqkv", (3 * dim,)),
            self._param(f"{nm}.wo", (dim, dim)),
            self._param(f"{nm}.bo", (dim,)),
        ]
        return self.raw("attention", [x], params, name=nm, heads=heads, dim=dim)

    def relu(self, x: str, name: str | None = None) -> str:
        return self.raw("relu", [x], name=name)

    def gelu(self, x: str, name: str | None = None) -> str:
        return self.raw("gelu", [x], name=name)

    def sigmoid(self, x: str, name: str | None = None) -> str:
        return self.raw("sigmoid", [x], name=name)

    def add(self, a: str, b: str, name: str | None = None) -> str:
        return self.raw("add", [a, b], name=name)

    def maxpool(self, x: str, window: int, stride: int,
                padding: str = "VALID", name: str | None = None) -> str:
        return self.raw("maxpool", [x], name=name, window=[window, window],
                        strides=[stride, stride], padding=padding)

    def avgpool(self, x: str, window: int, stride: int,
                padding: str = "VALID", name: str | None = None) -> str:
        return self.raw("avgpool", [x], name=name, window=[window, window],
                        strides=[stride, stride], padding=padding)

    def global_avgpool(self, x: str, name: str | None = None) -> str:
        return self.raw("global_avgpool", [x], name=name)

    def lrn(self, x: str, radius: int = 2, alpha: float = 1e-4,
            beta: float = 0.75, bias: float = 1.0, name: str | None = None) -> str:
        return self.raw("lrn", [x], name=name, radius=radius, alpha=alpha,
                        beta=beta, bias=bias)

    def concat(self, xs: Iterable[str], axis: int = -1, name: str | None = None) -> str:
        return self.raw("concat", list(xs), name=name, axis=axis)

    def flatten(self, x: str, name: str | None = None) -> str:
        return self.raw("flatten", [x], name=name)

    def reshape(self, x: str, shape: Iterable[int], name: str | None = None,
                batch_leading: bool | None = None) -> str:
        """``batch_leading`` says whether shape[0] is the batch, so that
        ``Graph.with_batch_size`` rewrites (True) or keeps (False) it."""
        attrs = {"shape": list(shape)}
        if batch_leading is not None:
            attrs["batch_leading"] = bool(batch_leading)
        return self.raw("reshape", [x], name=name, **attrs)

    def softmax(self, x: str, name: str | None = None) -> str:
        return self.raw("softmax", [x], name=name)

    def dropout(self, x: str, rate: float = 0.5, name: str | None = None) -> str:
        return self.raw("dropout", [x], name=name, rate=rate)

    def build(self, outputs: Iterable[str] | str, **meta) -> Graph:
        outs = (outputs,) if isinstance(outputs, str) else tuple(outputs)
        g = Graph(self.name, dict(self._inputs), outs, list(self._nodes),
                  dict(self._params), dict(meta))
        g.validate()
        return g
