"""A fault of the reference's quantizer that the port reproduces, pinned.

``fold_residual`` (tf2_tpu/transform/quantize.py:270, the port's
``transform/quantize._fold_residual``) can take a qdense that already holds
a folded residual as the candidate of a chained add: the new node keeps
only ``cand.inputs[0]``, so the first residual is dropped and es/eb are
rescaled a second time. On ``z = add(dense, rA)``, ``w = add(z, rB)`` with
rA and rB each feeding a second node, both packages give the same wrong
artifact; with rB defined after the dense, both raise in
``Graph.validate``. No graph of the zoo reaches it (the ViT's residual
stream always has two consumers). The fault is not fixed in either
package: the port reproduces the reference.
"""
import numpy as np
import pytest

from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import GraphBuilder as RefGraphBuilder
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.graph import GraphBuilder
from tf2_tpu_torch.transform import QuantSpec, quantize_graph
from tf2_tpu_torch.transform.export import _hash


def _chained_adds(builder, rb_after_dense: bool):
    """x -> dense rA, dense rB, dense d; z = d + rA; w = z + rB; rA and rB
    also feed o = rA + rB. With ``rb_after_dense`` rB's dense comes after
    d's in node order."""
    b = builder("chained_adds")
    x = b.input("x", (2, 4, 16))
    order = ["rA", "d", "rB"] if rb_after_dense else ["rA", "rB", "d"]
    vals = {name: b.dense(x, 16, 16, name=name) for name in order}
    z = b.add(vals["d"], vals["rA"], name="z")
    w = b.add(z, vals["rB"], name="w")
    o = b.add(vals["rA"], vals["rB"], name="o")
    return b.build([w, o])


def _quantize(quantize, spec_cls, graph):
    params = {k: np.asarray(v) for k, v in ref_init_params(graph, seed=0).items()}
    scales = {k: 0.05 for k in list(graph.inputs) + [n.name for n in graph.nodes]}
    spec = spec_cls(weight_bits=8, int8_residual=True, fold_residual=True)
    return quantize(graph, params, scales, spec)


def test_refold_drops_the_first_residual_in_both_packages():
    ref = _quantize(ref_quantize_graph, RefQuantSpec, _chained_adds(RefGraphBuilder, False))
    port = _quantize(quantize_graph, QuantSpec, _chained_adds(GraphBuilder, False))
    assert port.graph.to_json() == ref.graph.to_json()
    assert {k: _hash(v) for k, v in port.params.items()} == \
        {k: _hash(np.asarray(v)) for k, v in ref.params.items()}
    # the fault: d took z's fold (residual rA), then w's (residual rB); w
    # keeps d's input and rB, rA's term is gone, and d's es and eb carry
    # two rescalings
    nodes = port.graph.node_map()
    assert "z" not in nodes and nodes["w"].op == "qdense"
    assert nodes["w"].inputs == ("x__q", "rB")
    assert nodes["w"].params[0].startswith("d.")
    assert nodes["o"].op == "qadd" and nodes["o"].inputs == ("rA", "rB")


def test_refold_node_order_variant_raises_in_both_packages():
    """rB defined after d: the twice-folded node takes d's place in node
    order and consumes rB before its definition."""
    for quantize, spec_cls, builder in [(ref_quantize_graph, RefQuantSpec, RefGraphBuilder),
                                        (quantize_graph, QuantSpec, GraphBuilder)]:
        with pytest.raises(ValueError, match="node 'w' consumes 'rB' before definition"):
            _quantize(quantize, spec_cls, _chained_adds(builder, True))
