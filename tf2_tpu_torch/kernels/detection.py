"""Detection post-processing: SSD prior-box decode and batched greedy NMS
(the reference's is jnp under XLA, ``tf2_tpu/kernels/detection.py``, not a
Pallas kernel). The decode and the candidate selection are plain PyTorch on
the tensors' device; the greedy keep mask is the ``csrc/nms.cu`` kernel on
a CUDA tensor (``greedy_keep``), its plain version on a CPU tensor.

Every image and class is one row of batched tensors, as the reference's
``vmap``: candidates are sorted with a stable descending sort, so equal
scores keep the lower index first as ``jax.lax.top_k`` does (dequantized
int8 logits make many scores equal). The kernel sweeps each row greedily
in shared memory, with no wait on the host and no (k, k) IoU matrix, so a
CUDA graph captures the whole head. The plain version
(``greedy_keep_plain``) reaches the same mask as the fixpoint of
keep[i] = not any(keep[j] and IoU(j, i) > thresh for j < i), iterated from
all-kept over the whole (k, k) matrix, each round compared on the host.
Each f32 step is one IEEE operation (the kernel's too) and the exp is
taken in float64 and rounded once, so the card and the CPU give the same
bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

SOURCE = "nms.cu"
LAUNCHES = {"nms": 0}


def decode_boxes(loc: torch.Tensor, priors: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD box decode. loc (..., A, 4) deltas [dcx, dcy, dw, dh]; priors
    (A, 4) [cx, cy, w, h] in [0, 1]. -> (..., A, 4) [x1, y1, x2, y2]. The
    reference's op order; the exp in float64, rounded once."""
    pcx, pcy, pw, ph = priors.to(torch.float32).unbind(-1)
    dcx, dcy, dw, dh = loc.to(torch.float32).unbind(-1)

    def exp(v):
        return torch.exp(v.to(torch.float64)).to(torch.float32)

    cx = pcx + dcx * variances[0] * pw
    cy = pcy + dcy * variances[0] * ph
    w = pw * exp(dw * variances[1])
    h = ph * exp(dh * variances[1])
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, 4) x (..., n, 4) xyxy -> (..., m, n) IoU, in the
    reference's op order."""
    ax1, ay1, ax2, ay2 = (v[..., :, None] for v in a.unbind(-1))
    bx1, by1, bx2, by2 = (v[..., None, :] for v in b.unbind(-1))
    area_a = torch.clamp_min(ax2 - ax1, 0) * torch.clamp_min(ay2 - ay1, 0)
    area_b = torch.clamp_min(bx2 - bx1, 0) * torch.clamp_min(by2 - by1, 0)
    inter = (torch.clamp_min(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1), 0)
             * torch.clamp_min(torch.minimum(ay2, by2) - torch.maximum(ay1, by1), 0))
    union = area_a + area_b - inter
    return inter / torch.clamp_min(union, 1e-9)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., k, 4) xyxy -> (..., k, k) IoU."""
    return _pairwise_iou(boxes, boxes)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, the lower index first among
    equal values (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (..., A, d), idx (..., k) -> (..., k, d): an exact gather."""
    return torch.gather(table, -2, idx[..., None].expand(*idx.shape, table.shape[-1]))


def greedy_keep_plain(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Plain version of the kernel, on any device (``meta`` too): greedy
    NMS keep mask over score-sorted candidates (..., k, 4), a box kept
    unless a kept box before it overlaps it above ``iou_thresh``. The
    suppression matrix is strictly upper triangular, so the iteration from
    all-kept settles on the one fixpoint within k + 1 rounds; it stops at
    the first round that changes nothing (a wait on the host a round)."""
    k = boxes.shape[-2]
    sup = (iou_matrix(boxes) > iou_thresh) & torch.ones(
        (k, k), dtype=torch.bool, device=boxes.device).triu(1)
    keep = torch.ones(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    if keep.device.type == "meta":  # the shape pass: no values to iterate on
        return keep
    for _ in range(k + 1):
        new = ~(sup & keep[..., :, None]).any(dim=-2)
        if torch.equal(new, keep):
            break
        keep = new
    return keep


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.library(SOURCE)
    lib.tf2_nms_keep.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_float, ctypes.c_void_p]
    lib.tf2_nms_keep.restype = ctypes.c_int
    lib.tf2_nms_max_k.argtypes, lib.tf2_nms_max_k.restype = [], ctypes.c_int
    return lib


@functools.cache
def max_k() -> int:
    """The most candidates a row the kernel takes (one row in one block's
    shared memory), from the library built for the card."""
    return _lib().tf2_nms_max_k()


def greedy_keep(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """The greedy keep mask (..., k) of score-sorted candidates (..., k, 4)
    f32: the kernel on a CUDA tensor, the plain version on a CPU one (and
    in the ``meta`` shape pass). Raises on a CUDA tensor the kernel does
    not take (not contiguous f32, or k above ``max_k()``)."""
    if boxes.device.type in ("cpu", "meta"):
        return greedy_keep_plain(boxes, iou_thresh)
    build.check_operands(boxes.device, boxes=(boxes, torch.float32,
                                              (*boxes.shape[:-1], 4)))
    k = boxes.shape[-2]
    if k > max_k():
        raise ValueError(f"nms kernel: {k} candidates a row, at most {max_k()}")
    keep = torch.empty(boxes.shape[:-1], dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    rc = _lib().tf2_nms_keep(boxes.data_ptr(), keep.data_ptr(), keep.numel() // k, k,
                             build.f32(iou_thresh), build.raw_stream(boxes.device))
    build.check_launch(rc, "nms")
    LAUNCHES["nms"] += 1
    return keep


def sorted_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                      k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of each row, score-sorted: boxes (..., A, 4), scores
    (..., A) -> (boxes (..., k, 4), scores (..., k)). The boxes of
    zero-score candidates are zeroed, as the reference's are: they sort
    after every real candidate and, with IoU 0, suppress nothing. The boxes
    come out contiguous, as the kernel takes them (a gather on an expanded
    index leaves its strides)."""
    scores_k, idx = top_k(scores, k)
    boxes_k = _gather_rows(boxes, idx)
    boxes_k = torch.where((scores_k > 0.0)[..., None], boxes_k, torch.zeros_like(boxes_k))
    return boxes_k.contiguous(), scores_k


def nms_single_class(boxes: torch.Tensor, scores: torch.Tensor, k: int,
                     iou_thresh: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over the top k of one class, batched over leading axes.
    boxes (..., A, 4), scores (..., A). -> (boxes (..., k, 4), scores
    (..., k), keep (..., k)), score-sorted (``sorted_candidates``)."""
    boxes_k, scores_k = sorted_candidates(boxes, scores, k)
    return boxes_k, scores_k, greedy_keep(boxes_k, iou_thresh)


def class_rows(boxes: torch.Tensor, cls_scores: torch.Tensor, topk: int = 200,
               score_thresh: float = 0.01) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows ``batched_nms`` sweeps, one an image and foreground class:
    boxes (N, A, 4), cls_scores (N, A, C) -> (boxes (N, C - 1, k, 4),
    scores (N, C - 1, k)), k = min(topk, A), the scores below
    ``score_thresh`` zeroed before the sort."""
    n, a, c = cls_scores.shape
    sc = cls_scores[..., 1:].transpose(1, 2)  # (N, C - 1, A), classes 1..C-1
    sc = torch.where(sc >= score_thresh, sc, torch.zeros_like(sc))
    return sorted_candidates(boxes[:, None].expand(n, c - 1, a, 4), sc, min(topk, a))


def batched_nms(boxes: torch.Tensor, cls_scores: torch.Tensor, max_out: int = 100,
                topk: int = 200, iou_thresh: float = 0.45, score_thresh: float = 0.01,
                plain: bool = False) -> torch.Tensor:
    """boxes (N, A, 4); cls_scores (N, A, C), class 0 the background.
    -> (N, max_out, 6) [x1, y1, x2, y2, score, class], score-sorted, the
    suppressed and thresholded candidates with score 0. With ``plain`` the
    keep mask is the plain version's on any device."""
    n, _, c = cls_scores.shape
    bk, sk = class_rows(boxes, cls_scores, topk, score_thresh)
    k = sk.shape[-1]
    keep = (greedy_keep_plain if plain else greedy_keep)(bk, iou_thresh)
    sk = torch.where(keep, sk, torch.zeros_like(sk))
    cls = torch.arange(1, c, dtype=torch.float32, device=boxes.device)
    dets = torch.cat([bk, sk[..., None], cls[None, :, None, None].expand(n, c - 1, k, 1)],
                     dim=-1).reshape(n, (c - 1) * k, 6)
    _, idx = top_k(dets[..., 4], max_out)
    return _gather_rows(dets, idx)
