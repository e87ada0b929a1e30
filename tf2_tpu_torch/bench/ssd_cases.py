"""The two SSD score cases of ``bench/ssd_cases.py`` (:64-81), one copy for
the tests and ``chip_smoke.py``.

- ``random``: the artifact as built. Random weights give every class about
  1/21 of the softmax mass, so nearly every anchor clears the 0.01 score
  threshold and the greedy NMS chains run deep: the post-processing's worst
  case.
- ``background``: the same artifact with each conf head's eb (bias / s_out
  on its int8 grid, channel a * classes + c) raised by ``bg_bias / s_out``
  on the background channels and lowered by ``fg_bias / s_out`` on the
  others, pushing the background's softmax mass to about 99% for most
  anchors, as a trained detector's scores are. The backbone is untouched.
"""
from __future__ import annotations

import numpy as np

CASES = ("random", "background")


def background_dominated(graph, params, bg_bias: float = 8.0, fg_bias: float = 3.0) -> dict:
    """``params`` with the conf heads' eb shifted (the reference's
    ``representative_bg_dominated`` case). Raises unless the graph has the
    three conf heads."""
    classes = graph.meta.get("classes", 21)
    out = dict(params)
    heads = 0
    for node in graph.nodes:
        if node.op != "qconv2d" or not node.name.startswith("conf"):
            continue
        s_out = float(node.attrs["out_scale"])
        eb = np.array(params[node.params[2]], np.float32)
        eb[0::classes] += bg_bias / s_out
        for c in range(1, classes):
            eb[c::classes] -= fg_bias / s_out
        out[node.params[2]] = eb
        heads += 1
    if heads < 3:
        raise ValueError(f"{heads} conf heads found, expected 3")
    return out


def case_params(case: str, graph, params) -> dict:
    """The params of score case ``case`` (one of ``CASES``)."""
    if case == "random":
        return dict(params)
    if case == "background":
        return background_dominated(graph, params)
    raise KeyError(f"unknown SSD score case {case!r}; have {CASES}")
