"""The port's three stem routes against tf2_tpu's on the CPU:
``pack_phase_stem`` (the ``wpack2`` node, one stride-(2, 1) conv),
``space_to_depth_stem`` (pad -> space_to_depth -> a stride-1 VALID conv)
and ``fused_qstem``.

The passes on the zoo's four stems (ResNet and GoogLeNet 7x7 SAME,
SqueezeNet v1.1 3x3 VALID at an odd output width, SSD 3x3 SAME) give the
reference's graph JSON and tensor hashes; a small ResNet (batch 2, image
64, depths 1-1-1-1, calibrated scales) through ``Engine(optimize=True)``
equals ``RefEngine(optimize=True, phase_stem=False)`` at every int8 node
and in the logits. ``fused_qstem``'s plain path equals the reference
kernel test's plain int32 conv on its shape matrix. Tolerance 0
throughout. No test enters Pallas interpret mode."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph.ir import GraphBuilder as RefGraphBuilder
from tf2_tpu.graph.optimize import fuse_stem_quantize as ref_fuse_stem_quantize
from tf2_tpu.graph.optimize import pack_phase_stem as ref_pack_phase_stem
from tf2_tpu.graph.optimize import space_to_depth_stem as ref_space_to_depth_stem
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu.kernels import qstem as ref_qstem
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch.graph import execute, init_params
from tf2_tpu_torch.graph.optimize import (fuse_stem_quantize, pack_phase_stem,
                                          space_to_depth_stem)
from tf2_tpu_torch.kernels import dispatch, qstem
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.runtime.engine import _decode_pot4
from tf2_tpu_torch.transform import from_reference
from tf2_tpu_torch.transform.export import _hash

STEMS = {"resnet50": dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=10),
         "googlenet": dict(batch=2, image=64, classes=10),
         "squeezenet_v1_1": dict(batch=2, image=64, classes=10),  # VALID, OW 31
         "ssd": dict(batch=2, image=128, classes=21)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ref_params(g, seed=0):
    """Weights drawn with numpy (the port's init_params: quicker than the
    reference's), handed to both packages."""
    params = init_params(g, seed=seed)
    if g.meta.get("family") == "ssd":
        from tf2_tpu.models.ssd import init_priors
        params.update(init_priors(g))
    return params


def _ref_artifact(name, **kw):
    """The reference's W8 artifact (the stems are W8 at any width) with
    every activation scale 0.02."""
    g = ref_get_model(name, **kw)
    fg, fp = ref_fold(g, _ref_params(g))
    scales = dict.fromkeys(list(fg.inputs) + [n.name for n in fg.nodes], 0.02)
    return ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=8))


def _same(port_graph, port_params, ref_graph, ref_params):
    assert port_graph.to_json() == ref_graph.to_json()
    assert {k: _hash(np.asarray(v)) for k, v in port_params.items()} == \
        {k: _hash(np.asarray(v)) for k, v in ref_params.items()}


@pytest.fixture(scope="module", params=list(STEMS))
def stem_art(request):
    return request.param, _ref_artifact(request.param, **STEMS[request.param])


def test_pack_phase_stem_matches_reference(stem_art):
    name, art = stem_art
    ref = ref_pack_phase_stem(*ref_fuse_stem_quantize(art.graph, art.params))
    port = pack_phase_stem(*fuse_stem_quantize(*from_reference(art.graph.to_json(),
                                                               art.params)))
    _same(*port, *ref)
    stem = port[0].nodes[0]
    assert stem.attrs["wfmt"] == "wpack2" and stem.params[0] == f"{stem.name}.wpack"
    if name == "squeezenet_v1_1":
        assert stem.attrs["padding"] == "VALID" and stem.attrs["pack_ow"] == 31


@pytest.mark.parametrize("fused", [False, True])
def test_space_to_depth_stem_matches_reference(stem_art, fused):
    """Both placement domains: before the stem's quantize (fused=False)
    and, after fuse_stem_quantize, on the raw image with the conv keeping
    s_in. SqueezeNet's VALID stem does not match: both passes skip it."""
    name, art = stem_art
    g, p = art.graph, art.params
    pg, pp = from_reference(g.to_json(), p)
    if fused:
        g, p = ref_fuse_stem_quantize(g, p)
        pg, pp = fuse_stem_quantize(pg, pp)
    ref = ref_space_to_depth_stem(g, p)
    port = space_to_depth_stem(pg, pp)
    _same(*port, *ref)
    ops = [n.op for n in port[0].nodes[:4]]
    if name == "squeezenet_v1_1":
        assert port[0].to_json() == pg.to_json()
    elif fused:
        assert ops[:3] == ["pad", "space_to_depth", "qconv2d"]
        assert port[0].nodes[0].inputs == ("image",) and "s_in" in port[0].nodes[2].attrs
    else:
        assert ops[:3] == ["pad", "space_to_depth", "quantize"]


def test_optimize_is_a_no_op_after_phase_stem(stem_art, caplog):
    """With phase_stem on, the stem is wpack2 when space_to_depth_stem runs:
    the pass warns and changes nothing, in both packages."""
    name, art = stem_art
    port = Engine(*from_reference(art.graph.to_json(), art.params), device="cpu",
                  phase_stem=True)
    both = Engine(*from_reference(art.graph.to_json(), art.params), device="cpu",
                  phase_stem=True, optimize=True)
    assert both.graph.to_json() == port.graph.to_json()
    assert "does not match the stem pattern" in caplog.text
    ref = RefEngine(art.graph, art.params, phase_stem=True, merge_1x1=False)
    ref_both = RefEngine(art.graph, art.params, phase_stem=True, merge_1x1=False,
                         optimize=True)
    assert ref_both.graph.to_json() == ref.graph.to_json()


def test_pack_phase_stem_even_kernel_fault_is_the_references():
    """The reference's pass (tf2_tpu/graph/optimize.py:161) gives a
    negative right pad for an even kernel with VALID padding and an odd
    width; the port's reproduces it, and both executors then refuse the
    node (jnp.pad and the port's check). A graph outside the zoo: a 4x4/s2
    VALID stem on a 9x9 image."""
    rb = RefGraphBuilder("even_stem")
    x = rb.input("image", (1, 9, 9, 3))
    x = rb.relu(rb.conv2d(x, 3, 8, 4, stride=2, padding="VALID", name="stem"), name="stem_relu")
    g = rb.build(rb.global_avgpool(x, name="gap"))
    params = _ref_params(g)
    scales = dict.fromkeys(list(g.inputs) + [n.name for n in g.nodes], 0.02)
    art = ref_quantize_graph(g, params, scales, RefQuantSpec(weight_bits=8))
    ref = ref_pack_phase_stem(*ref_fuse_stem_quantize(art.graph, art.params))
    port = pack_phase_stem(*fuse_stem_quantize(*from_reference(art.graph.to_json(),
                                                               art.params)))
    _same(*port, *ref)
    node = port[0].nodes[0]
    assert node.attrs["wfmt"] == "wpack2" and node.attrs["pack_pad_w"] == [0, -1]
    x = np.zeros((1, 9, 9, 3), np.float32)
    with pytest.raises(ValueError, match="negative"):
        dispatch.qconv2d(node, {k: torch.as_tensor(v) for k, v in port[1].items()},
                         torch.as_tensor(x))
    with pytest.raises(ValueError):
        ref_dispatch.qconv2d(ref[0].nodes[0], ref[1], jnp.asarray(x))


@pytest.fixture(scope="module")
def resnet():
    """A small ResNet with calibrated scales, the reference's
    Engine(optimize=True, phase_stem=False) and its values of every node."""
    g = ref_get_model("resnet50", **STEMS["resnet50"])
    fg, fp = ref_fold(g, _ref_params(g))
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5))
    ref = RefEngine(art.graph, art.params, optimize=True, phase_stem=False)
    out, env = jax.jit(ref_execute(ref.graph, intermediates=True))(ref.params,
                                                                    image=jnp.asarray(x))
    return dict(art=art, x=x, ref=ref, logits=np.asarray(out),
                env={k: np.asarray(v) for k, v in env.items()})


def test_optimize_engine_matches_reference(resnet):
    """The port's Engine(optimize=True): the reference's graph once the
    convs the port keeps packed are decoded too; every int8 node, the pad
    and space_to_depth values and the logits equal; the stem is a
    stride-1 4x4 VALID conv on 12 channels of the raw image."""
    eng = Engine(*from_reference(resnet["art"].graph.to_json(), resnet["art"].params),
                 device="cpu", optimize=True, block_fusion=False)
    params = {k: v.numpy() for k, v in eng.params.items()}
    pot4 = {n.name for n in eng.graph.nodes if n.attrs.get("wfmt") == "pot4"}
    decoded, _ = _decode_pot4(eng.graph, params, pot4)
    assert json.loads(decoded.to_json()) == json.loads(resnet["ref"].graph.to_json())
    stem = eng.graph.nodes[2]
    assert stem.attrs["kshape"][:3] == [4, 4, 12] and stem.attrs["strides"] == [1, 1]
    out, env = execute(eng.graph, intermediates=True)(eng.params,
                                                      image=torch.as_tensor(resnet["x"]))
    checked = 0
    for n in eng.graph.nodes:
        want = resnet["env"][n.name]
        if want.dtype == np.int8 or n.op in ("pad", "space_to_depth"):
            np.testing.assert_array_equal(env[n.name].numpy(), want, err_msg=n.name)
            checked += 1
    assert checked == 26
    np.testing.assert_array_equal(out.numpy(), resnet["logits"])


def _ref_plain(x_q, w_q, es, eb, relu, padding):
    """tests/kernels/test_qstem.py's reference: int32 lax conv + epilogue."""
    acc = lax.conv_general_dilated(jnp.asarray(x_q), jnp.asarray(w_q), (2, 2), padding,
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                   preferred_element_type=jnp.int32)
    y = acc.astype(jnp.float32) * jnp.asarray(es) + jnp.asarray(eb)
    if relu:
        y = jnp.maximum(y, 0.0)
    return np.asarray(jnp.clip(jnp.round(y), -127, 127).astype(jnp.int8))


def _mk(b, h, w, cin, cout, k, seed=0):
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-127, 128, (b, h, w, cin), dtype=np.int8)
    w_q = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    es = rng.uniform(1e-4, 5e-3, cout).astype(np.float32)
    eb = rng.normal(size=cout).astype(np.float32) * 0.1
    return x_q, w_q, es, eb


@pytest.mark.parametrize("b,h,cin,cout,k,padding,relu", [
    (2, 64, 3, 32, 7, "SAME", True), (2, 96, 3, 32, 7, "SAME", True),
    (2, 64, 3, 32, 5, "SAME", True), (2, 48, 3, 32, 3, "SAME", True),
    (1, 224, 3, 64, 7, "SAME", True),
    (2, 63, 3, 32, 3, "VALID", False), (3, 37, 1, 16, 5, "SAME", False),
    (2, 41, 2, 24, 3, "VALID", True), (1, 30, 4, 40, 7, "SAME", True)])
def test_fused_qstem_plain_matches_reference(b, h, cin, cout, k, padding, relu):
    """The reference kernel test's matrix (first five), then VALID, relu
    off, odd sizes and cin 1, 2, 4."""
    x_q, w_q, es, eb = _mk(b, h, h, cin, cout, k, seed=k + h)
    got = qstem.fused_qstem(torch.as_tensor(x_q), torch.as_tensor(w_q), es, eb,
                            padding=padding, relu=relu)
    np.testing.assert_array_equal(got.numpy(), _ref_plain(x_q, w_q, es, eb, relu, padding))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_fused_qstem_fused_quantize(padding):
    """f32 input with ``scale``: equal to quantize-then-conv."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    _, w_q, es, eb = _mk(2, 64, 64, 3, 32, 7, seed=9)
    x_q = np.clip(np.round(x / np.float32(0.02)), -127, 127).astype(np.int8)
    got = qstem.fused_qstem(torch.as_tensor(x), w_q, es, eb, padding=padding, relu=False,
                            scale=0.02)
    np.testing.assert_array_equal(got.numpy(), _ref_plain(x_q, w_q, es, eb, False, padding))


@pytest.mark.parametrize("h,w,k,padding", [(224, 224, 7, "SAME"), (224, 224, 3, "VALID"),
                                           (256, 256, 3, "SAME"), (37, 50, 5, "SAME"),
                                           (64, 64, 1, "SAME")])
def test_qstem_geometry_taps_and_folds_match_reference(h, w, k, padding):
    assert qstem.stem_geometry(h, w, k, k, padding) == ref_qstem.stem_geometry(h, w, k, k,
                                                                               padding)
    for cin in (1, 3, 4):
        assert qstem.stem_taps(k, k, cin) == ref_qstem.stem_taps(k, k, cin)
        _, w_q, _, _ = _mk(1, 8, 8, cin, 16, k, seed=cin)
        np.testing.assert_array_equal(qstem.fold_weight(w_q).numpy(), ref_qstem.fold_weight(w_q))
    rng = np.random.default_rng(h + k)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    x_q = rng.integers(-127, 128, (2, h, w, 3), dtype=np.int8)
    np.testing.assert_array_equal(
        qstem.fold_image(torch.as_tensor(x), k, k, padding, scale=0.02).numpy(),
        np.asarray(ref_qstem.fold_image(jnp.asarray(x), k, k, padding, scale=0.02)))
    np.testing.assert_array_equal(
        qstem.fold_image(torch.as_tensor(x_q), k, k, padding).numpy(),
        np.asarray(ref_qstem.fold_image(jnp.asarray(x_q), k, k, padding)))


@pytest.mark.parametrize("kshape,strides,padding,xshape", [
    ((7, 7, 3, 64), (2, 2), "SAME", (64, 224, 224, 3)),
    ((7, 7, 3, 64), (1, 1), "SAME", (64, 224, 224, 3)),
    ((7, 7, 64, 64), (2, 2), "SAME", (64, 224, 224, 64)),
    ((4, 4, 3, 64), (2, 2), "SAME", (64, 224, 224, 3)),
    ((3, 3, 3, 32), (2, 2), "SAME", (64, 256, 256, 3)),
    ((3, 3, 3, 64), (2, 2), "VALID", (1, 224, 224, 3)),
    ((3, 3, 4, 8), (2, 2), "SAME", (1, 1024, 1024, 4)),    # the 4 MiB fold limit
    ((3, 3, 1, 8), (2, 2), "SAME", (1, 2048, 2048, 1)),
    ((5, 5, 3, 8), (2, 2), "VALID", (1, 3, 3, 3)),         # empty output
    ((3, 3, 3, 8), (2, 2), "SAME", (224, 224, 3))])        # not 4-D
def test_qstem_covers_matches_reference(kshape, strides, padding, xshape):
    want = ref_qstem.covers(kshape, strides, padding, 1, xshape)
    assert qstem.covers(kshape, strides, padding, 1, xshape) == want
    assert qstem.covers(kshape, strides, padding, 2, xshape) is False


def test_fused_qstem_refuses_what_covers_refuses():
    x = torch.zeros((1, 16, 16, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    assert qstem.fused_qstem(x, w, np.ones(4, np.float32), np.zeros(4, np.float32),
                             padding="SAME", relu=True) is None
