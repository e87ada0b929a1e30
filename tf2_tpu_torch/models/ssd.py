"""SSD-style detector as an IR graph (``BASELINE.json`` configs[3]): a
residual-free stride-2 backbone (stem 3x3/2 on 3 channels -> 32), three
feature maps at /16, /32 and /64, per-scale 3x3 conv heads predicting 4 box
deltas and the class scores for each of 3 anchors a cell, a prior-box grid
per scale, then softmax, ``box_decode`` and fixed-shape NMS
(``kernels/detection.py``). The convs quantize through the Transform Kit;
the scores, decode and NMS run in f32 behind dequantize."""
from __future__ import annotations

import itertools
import math

import numpy as np

from ..graph.ir import Graph, GraphBuilder

SCALES = (0.12, 0.3, 0.6)


def make_priors(feature_sizes, image: int, scales, ratios=(1.0, 2.0, 0.5)) -> np.ndarray:
    """Grid of prior boxes [cx, cy, w, h] in [0, 1] for each feature map."""
    priors = []
    for fs, scale in zip(feature_sizes, scales):
        for i, j in itertools.product(range(fs), repeat=2):
            cy, cx = (i + 0.5) / fs, (j + 0.5) / fs
            for r in ratios:
                priors.append([cx, cy, scale * math.sqrt(r), scale / math.sqrt(r)])
    return np.clip(np.asarray(priors, np.float32), 0.0, 1.0)


def _conv_bn_relu(b: GraphBuilder, x: str, cin: int, cout: int, k: int, s: int, name: str) -> str:
    x = b.conv2d(x, cin, cout, k, stride=s, bias=False, name=name)
    x = b.batch_norm(x, cout, name=f"{name}_bn")
    return b.relu(x, name=f"{name}_relu")


def build(batch: int = 1, image: int = 256, classes: int = 21,
          anchors_per_cell: int = 3) -> Graph:
    b = GraphBuilder("ssd_resnetish")
    x = b.input("image", (batch, image, image, 3))
    x = _conv_bn_relu(b, x, 3, 32, 3, 2, "stem")          # /2
    x = _conv_bn_relu(b, x, 32, 64, 3, 2, "s1a")          # /4
    x = _conv_bn_relu(b, x, 64, 64, 3, 1, "s1b")
    x = _conv_bn_relu(b, x, 64, 128, 3, 2, "s2a")         # /8
    x = _conv_bn_relu(b, x, 128, 128, 3, 1, "s2b")
    f0 = _conv_bn_relu(b, x, 128, 256, 3, 2, "s3a")       # /16: feature 0
    f1 = _conv_bn_relu(b, f0, 256, 256, 3, 2, "s4a")      # /32: feature 1
    f2 = _conv_bn_relu(b, f1, 256, 256, 3, 2, "s5a")      # /64: feature 2

    feats = [(f0, 256, image // 16), (f1, 256, image // 32), (f2, 256, image // 64)]
    locs, confs = [], []
    for i, (f, c, fs) in enumerate(feats):
        loc = b.conv2d(f, c, anchors_per_cell * 4, 3, name=f"loc{i}")
        conf = b.conv2d(f, c, anchors_per_cell * classes, 3, name=f"conf{i}")
        locs.append(b.reshape(loc, (batch, fs * fs * anchors_per_cell, 4),
                              name=f"loc{i}_r", batch_leading=True))
        confs.append(b.reshape(conf, (batch, fs * fs * anchors_per_cell, classes),
                               name=f"conf{i}_r", batch_leading=True))
    loc_all = b.concat(locs, axis=1, name="loc_all")
    conf_all = b.concat(confs, axis=1, name="conf_all")
    scores = b.softmax(conf_all, name="scores")

    priors = make_priors([image // 16, image // 32, image // 64], image, SCALES,
                         ratios=(1.0, 2.0, 0.5)[:anchors_per_cell])
    a = priors.shape[0]
    b._param("priors", (a, 4))
    boxes = b.raw("box_decode", [loc_all], ["priors"], name="boxes", variances=[0.1, 0.2])
    dets = b.raw("nms", [boxes, scores], name="detections", max_out=100,
                 topk=min(100, a), iou_thresh=0.45, score_thresh=0.01)
    g = b.build(dets, family="ssd", num_priors=a, classes=classes)
    g.meta["priors_value"] = None  # the array comes from init_priors
    return g


def init_priors(graph: Graph) -> dict[str, np.ndarray]:
    """The priors of this graph's configuration (they are not learned):
    merge into the params after ``init_params``."""
    image = graph.inputs["image"].shape[1]
    pr = make_priors([image // 16, image // 32, image // 64], image, SCALES)
    if pr.shape[0] != graph.meta["num_priors"]:
        raise ValueError(f"priors {pr.shape[0]} != num_priors {graph.meta['num_priors']}")
    return {"priors": pr}
