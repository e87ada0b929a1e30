"""Executors of the detection-head ops (``box_decode``, ``nms``) on the
device the tensors live on (``kernels/detection.py``): the NMS's greedy
keep mask is a kernel (``kernel="plain"``: its plain version)."""
from __future__ import annotations

from ..kernels import detection
from .execute import register_op


@register_op("box_decode")
def _box_decode(node, params, loc):
    return detection.decode_boxes(loc, params[node.params[0]],
                                  tuple(node.attrs.get("variances", (0.1, 0.2))))


@register_op("nms", kernel=True)
def _nms(node, params, boxes, scores, kernel=None):
    return detection.batched_nms(
        boxes, scores, max_out=node.attrs.get("max_out", 100),
        topk=node.attrs.get("topk", 200), iou_thresh=node.attrs.get("iou_thresh", 0.45),
        score_thresh=node.attrs.get("score_thresh", 0.01), plain=kernel == "plain")
