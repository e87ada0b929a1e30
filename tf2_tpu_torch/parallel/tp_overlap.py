"""Ring-overlapped tensor-parallel matmul, the counterpart of the
reference's ``tf2_tpu/parallel/tp_overlap.py``.

The tp layout shards a layer's output channels, so the next layer needs
them all-gathered. ``gspmd_matmul`` does that in two serial steps
(all-gather, then one product); ``allgather_matmul`` passes the K-chunks
around the tp ring instead and multiplies each chunk as it holds it, with
the next chunk's send and receive posted first (``dist.batch_isend_irecv``),
so the transfer overlaps the product, as the reference's hoisted
``ppermute`` does:

    acc  = y_local @ w_rows(self)
    hop  : post send(chunk -> prev), recv(next); acc += chunk @ w_rows(owner)

Both compute ``all_gather(y, tp) @ w`` (w replicated). int8 operands
accumulate in int32 through ``torch._int_mm`` (exact), each B given
column-major, the layout on which it is fastest (``bench/peaks.py``); f32
through ``torch.matmul``. The reference computes this product with
``jnp.dot``, outside any Pallas kernel. Under gloo the chunks travel
through the host (``parallel/mesh.py``'s ``to_collective`` and
``from_collective``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import MeshConfig, all_gather_last, from_collective, to_collective


def _b_operand(w: torch.Tensor) -> torch.Tensor:
    """w as the product's B: an int8 B column-major (``torch._int_mm``'s
    fast layout), anything else as it is."""
    return w.t().contiguous().t() if w.dtype == torch.int8 else w


def _dot(y: torch.Tensor, w: torch.Tensor, acc_dtype: torch.dtype) -> torch.Tensor:
    """y @ w; an int8 w is taken as ``_b_operand`` gives it."""
    if y.dtype == torch.int8:
        if acc_dtype != torch.int32:
            raise ValueError(f"int8 operands accumulate in int32, not {acc_dtype}")
        return torch._int_mm(y.contiguous(), w)
    return torch.matmul(y.to(acc_dtype), w.to(acc_dtype))


def allgather_matmul(cfg: MeshConfig, y_local: torch.Tensor, w: torch.Tensor,
                     acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """all_gather(y, tp) @ w with ring-overlapped chunks. ``y_local``:
    (M, K / tp), this rank's K-chunk (tp order); ``w``: (K, N), replicated.
    Returns (M, N) on every rank."""
    n, me = cfg.tp, cfg.tp_index
    kc = y_local.shape[1]
    if w.shape[0] != n * kc:
        raise ValueError(f"w has {w.shape[0]} rows, y's chunks give {n} x {kc}")
    if n == 1:
        return _dot(y_local, _b_operand(w), acc_dtype)
    # each owner's rows of w, laid out once a call
    rows = [_b_operand(w[o * kc:(o + 1) * kc]) for o in range(n)]
    group = cfg.tp_group
    ranks = dist.get_process_group_ranks(group)
    prev, nxt = ranks[(me - 1) % n], ranks[(me + 1) % n]
    held = to_collective(y_local, group)
    acc = None
    for i in range(n):
        work, incoming = [], None
        if i < n - 1:  # the last hop sends nothing
            incoming = torch.empty_like(held)
            work = dist.batch_isend_irecv([dist.P2POp(dist.isend, held, prev, group),
                                           dist.P2POp(dist.irecv, incoming, nxt, group)])
        owner = (me + i) % n  # the chunk held at hop i came from rank me + i
        part = _dot(from_collective(held, y_local), rows[owner], acc_dtype)
        acc = part if acc is None else acc + part
        for wk in work:
            wk.wait()
        held = incoming
    return acc


def gspmd_matmul(cfg: MeshConfig, y_local: torch.Tensor, w: torch.Tensor,
                 acc_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The baseline: all-gather y's chunks, then one product."""
    return _dot(all_gather_last(cfg, y_local), _b_operand(w), acc_dtype)
