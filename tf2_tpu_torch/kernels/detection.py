"""Detection post-processing: SSD prior-box decode and batched greedy NMS,
plain PyTorch on the tensors' device (the reference's is jnp under XLA,
``tf2_tpu/kernels/detection.py``, not a Pallas kernel).

Every image and class is one row of batched tensors, as the reference's
``vmap``: candidates are sorted with a stable descending sort, so equal
scores keep the lower index first as ``jax.lax.top_k`` does (dequantized
int8 logits make many scores equal); the greedy keep mask is the fixpoint
of keep[i] = not any(keep[j] and IoU(j, i) > thresh for j < i), reached by
iterating from all-kept over the whole (k, k) matrix. Each f32 step is one
IEEE operation and the exp is taken in float64 and rounded once, so the
card and the CPU give the same bits.
"""
from __future__ import annotations

import torch


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


def greedy_keep(boxes: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted candidates (..., k, 4): a box
    is kept unless a kept box before it overlaps it above ``iou_thresh``.
    The suppression matrix is strictly upper triangular, so the iteration
    from all-kept settles on the one fixpoint within k + 1 rounds; it stops
    at the first round that changes nothing."""
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


def nms_single_class(boxes: torch.Tensor, scores: torch.Tensor, k: int,
                     iou_thresh: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy NMS over the top k of one class, batched over leading axes.
    boxes (..., A, 4), scores (..., A). -> (boxes (..., k, 4), scores
    (..., k), keep (..., k)), score-sorted. The boxes of zero-score
    candidates are zeroed, as the reference's are: they sort after every
    real candidate and, with IoU 0, suppress nothing."""
    scores_k, idx = top_k(scores, k)
    boxes_k = _gather_rows(boxes, idx)
    boxes_k = torch.where((scores_k > 0.0)[..., None], boxes_k, torch.zeros_like(boxes_k))
    return boxes_k, scores_k, greedy_keep(boxes_k, iou_thresh)


def batched_nms(boxes: torch.Tensor, cls_scores: torch.Tensor, max_out: int = 100,
                topk: int = 200, iou_thresh: float = 0.45,
                score_thresh: float = 0.01) -> torch.Tensor:
    """boxes (N, A, 4); cls_scores (N, A, C), class 0 the background.
    -> (N, max_out, 6) [x1, y1, x2, y2, score, class], score-sorted, the
    suppressed and thresholded candidates with score 0."""
    n, a, c = cls_scores.shape
    k = min(topk, a)
    sc = cls_scores[..., 1:].transpose(1, 2)  # (N, C - 1, A), classes 1..C-1
    sc = torch.where(sc >= score_thresh, sc, torch.zeros_like(sc))
    bk, sk, keep = nms_single_class(boxes[:, None].expand(n, c - 1, a, 4), sc, k, iou_thresh)
    sk = torch.where(keep, sk, torch.zeros_like(sk))
    cls = torch.arange(1, c, dtype=torch.float32, device=boxes.device)
    dets = torch.cat([bk, sk[..., None], cls[None, :, None, None].expand(n, c - 1, k, 1)],
                     dim=-1).reshape(n, (c - 1) * k, 6)
    _, idx = top_k(dets[..., 4], max_out)
    return _gather_rows(dets, idx)
