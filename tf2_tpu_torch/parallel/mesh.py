"""The (dp, tp) mesh over ``torch.distributed``, the counterpart of the
reference's ``tf2_tpu/parallel/mesh.py``.

Ranks form a row-major (dp, tp) grid, as the reference's ``make_mesh``
reshapes its devices: rank r sits at (r // tp, r % tp). dp splits the batch
(each dp index runs its own rows, with all the weights); tp splits output
channels (each tp index computes its slice of a layer's output channels,
and the slices are all-gathered before the next layer). The reference
leaves both to GSPMD from its ``NamedSharding`` annotations; here the
runtime Engine (``runtime/engine.py``) applies them explicitly, with the
collectives below.

``param_shardings`` and ``input_shardings`` return, per name, the entries of
the reference's ``PartitionSpec``: ``(None, None, "tp")`` for a param whose
last axis is split over tp, ``("dp", None, None, None)`` for an input whose
batch is split over dp, ``()`` for a replicated value.

The collectives run on the device of the group's backend: the rank's card
for NCCL, the host for gloo. Under gloo a tensor on the card is copied to
the host, exchanged there and copied back. ``to_collective`` and
``from_collective`` make those copies for every collective of the port
(here, ``tp_overlap``, ``runtime/distributed.barrier`` and the lockstep
broadcasts of ``serve/multihost``); the backend is the caller's choice
(``runtime/distributed.py``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..graph.ir import Graph, Node

# params whose LAST axis is the output-channel dim -> shard over tp
_TP_LAST_AXIS_SUFFIXES = (".wp", ".wq", ".es", ".eb", ".w", ".b",
                          ".scale", ".offset", ".mean", ".var")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """A (dp, tp) grid of ranks and this process's place in it. The groups
    are ``None`` where their axis is 1, and in a planning config (no
    process group)."""
    dp: int
    tp: int
    rank: int = 0
    dp_group: object = None   # the ranks of this tp index, in dp order
    tp_group: object = None   # the ranks of this dp index, in tp order

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp


def make_mesh(tp: int = 1, world: int | None = None) -> MeshConfig:
    """dp is inferred as world // tp. ``world`` defaults to the process
    group's size, or 1 where none exists; a ``world`` given without a
    process group makes a config for planning only (rank 0, no groups)."""
    initialized = dist.is_available() and dist.is_initialized()
    if world is None:
        world = dist.get_world_size() if initialized else 1
    elif initialized and world != dist.get_world_size():
        raise ValueError(f"world {world} != the process group's {dist.get_world_size()}")
    if tp < 1 or world % tp:
        raise ValueError(f"tp={tp} does not divide device count {world}")
    dp = world // tp
    if not initialized:
        return MeshConfig(dp, tp)
    rank = dist.get_rank()
    # every rank creates every group, in one order (dist.new_group's rule)
    tp_group = dp_group = None
    if tp > 1:
        for d in range(dp):
            g = dist.new_group([d * tp + t for t in range(tp)])
            if d == rank // tp:
                tp_group = g
    if dp > 1:
        for t in range(tp):
            g = dist.new_group([d * tp + t for d in range(dp)])
            if t == rank % tp:
                dp_group = g
    return MeshConfig(dp, tp, rank, dp_group, tp_group)


def _shards_last(name: str, shape, cfg: MeshConfig) -> bool:
    return (any(name.endswith(s) for s in _TP_LAST_AXIS_SUFFIXES) and cfg.tp > 1
            and len(shape) > 0 and shape[-1] % cfg.tp == 0)


def param_shardings(graph: Graph, cfg: MeshConfig) -> dict[str, tuple]:
    """Output-channel (last-axis) sharding over tp for weight-bearing
    params; everything else replicated. A last axis tp does not divide is
    replicated (correct, just not distributed)."""
    return {name: (None,) * (len(spec.shape) - 1) + ("tp",)
            if _shards_last(name, spec.shape, cfg) else ()
            for name, spec in graph.params.items()}


def input_shardings(graph: Graph, cfg: MeshConfig) -> dict[str, tuple]:
    """Batch (axis 0) sharded over dp where dp divides it."""
    return {name: ("dp",) + (None,) * (len(spec.shape) - 1)
            if spec.shape and spec.shape[0] % cfg.dp == 0 else ()
            for name, spec in graph.inputs.items()}


def tp_shardable(node: Node, graph: Graph, cfg: MeshConfig) -> bool:
    """Does the node compute its slice of the output channels bit-equal to
    the same slice of the whole node? An ungrouped ``qconv2d`` (the fused
    stem and the ``wpack2`` stem included) or a ``qdense``, each of whose
    params ``param_shardings`` splits on the last axis: its int8 requant is
    per output channel and its output channels independent. Every other
    node runs whole on every rank."""
    if cfg.tp == 1 or node.op not in ("qconv2d", "qdense") or node.attrs.get("groups", 1) != 1:
        return False
    return all(_shards_last(p, graph.params[p].shape, cfg) for p in node.params)


def channel_bounds(cout: int, cfg: MeshConfig) -> tuple[int, int]:
    """This rank's output channels [lo, hi) of a tp-sharded node."""
    per = cout // cfg.tp
    return cfg.tp_index * per, (cfg.tp_index + 1) * per


def local_node(node: Node, cfg: MeshConfig) -> Node:
    """The node with its output channels cut to this rank's slice (the
    ``kshape`` and, for a ``wpack2`` stem, ``pack_kshape``)."""
    attrs = dict(node.attrs)
    for key in ("kshape", "pack_kshape"):
        if key in attrs:
            attrs[key] = list(attrs[key][:-1]) + [attrs[key][-1] // cfg.tp]
    return Node(node.name, node.op, node.inputs, node.params, attrs)


def batch_bounds(batch: int, cfg: MeshConfig) -> tuple[int, int] | None:
    """This rank's rows [lo, hi) of a batch dp divides; None where the
    batch is replicated (dp 1, or dp does not divide it)."""
    if cfg.dp == 1 or batch % cfg.dp:
        return None
    per = batch // cfg.dp
    return cfg.dp_index * per, (cfg.dp_index + 1) * per


def collective_device(group=None) -> torch.device:
    """Where the group's collectives take their tensors (the default
    group's where ``group`` is None): the current card for NCCL, the host
    for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def to_collective(x: torch.Tensor, group=None) -> torch.Tensor:
    """x, contiguous, on the device of the group's collectives: under gloo
    a tensor on the card is copied to the host."""
    return x.to(collective_device(group)).contiguous()


def from_collective(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result back on ``like``'s device (from the host to
    the card under gloo)."""
    return t.to(like.device)


def _all_gather(x: torch.Tensor, n: int, group, dim: int) -> torch.Tensor:
    """Concatenate the group's tensors along ``dim``, in group-rank order,
    exchanged on the device of the group's collectives."""
    src = to_collective(x, group)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return from_collective(torch.cat(parts, dim=dim), x)


def all_gather_last(cfg: MeshConfig, x: torch.Tensor) -> torch.Tensor:
    """The tp group's shards concatenated along the last axis, in tp
    order (the whole output of a tp-sharded node)."""
    if cfg.tp == 1:
        return x
    return _all_gather(x, cfg.tp, cfg.tp_group, -1)


def gather_batch(cfg: MeshConfig, x: torch.Tensor) -> torch.Tensor:
    """The dp group's rows concatenated along axis 0, in dp order."""
    if cfg.dp == 1:
        return x
    return _all_gather(x, cfg.dp, cfg.dp_group, 0)
