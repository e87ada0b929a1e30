"""The port's Engine against tf2_tpu's on a small ResNet (batch 2, image 64,
depths (1,1,1,1), 64 classes) with activation scales from the reference's
calibration: every int8 node, and the logits, equal exactly, with the stem
as a stride-2 conv (the port's default) and as the reference's default
``wpack2`` node (``phase_stem=True`` in both)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.optimize import fuse_stem_quantize as ref_fuse_stem_quantize
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import Graph, execute
from tf2_tpu_torch.graph.optimize import fuse_stem_quantize
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference, load_artifact, save_artifact

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in parallel workers beside multi-process JAX tests;
    one intra-op thread keeps these float64 checks from starving them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def case():
    g = ref_get_model("resnet50", **SMALL)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()})
    x = np.random.default_rng(0).standard_normal(g.inputs["image"].shape).astype(np.float32)
    scales = ref_calibrate(fg, fp, [{"image": jnp.asarray(x)}])
    art = ref_quantize_graph(fg, fp, scales, RefQuantSpec(weight_bits=4, pot_candidates=5))
    ref_logits = np.asarray(RefEngine(art.graph, art.params).run(image=x))
    ref_env = {}
    for phase_stem in (False, True):
        ref = RefEngine(art.graph, art.params, phase_stem=phase_stem)
        _, env = jax.jit(ref_execute(ref.graph, intermediates=True))(
            ref.params, image=jnp.asarray(x))
        ref_env[phase_stem] = {k: np.asarray(v) for k, v in env.items()}
    return dict(art=art, x=x, ref_logits=ref_logits, ref_env=ref_env)


def _port_engine(case, phase_stem=False):
    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    return Engine(g, p, device="cpu", phase_stem=phase_stem, block_fusion=False)


def _logits_equal_reference_engine(case, phase_stem):
    kernels.reset_launch_counts()
    y = _port_engine(case, phase_stem).run(image=case["x"])
    assert y.shape == (2, 64) and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), case["ref_logits"])
    # on the CPU every wrapper takes its plain version
    assert set(kernels.launch_counts().values()) == {0}


def test_logits_equal_reference_engine(case):
    _logits_equal_reference_engine(case, False)


def test_logits_equal_reference_engine_phase_stem(case):
    _logits_equal_reference_engine(case, True)


def _every_int8_node_equals_reference(case, phase_stem):
    eng = _port_engine(case, phase_stem)
    _, env = execute(eng.graph, intermediates=True)(eng.params,
                                                    image=torch.as_tensor(case["x"]))
    int8_nodes = [n.name for n in eng.graph.nodes if env[n.name].dtype == torch.int8]
    assert len(int8_nodes) == 24
    assert (eng.graph.nodes[0].attrs["wfmt"] == "wpack2") == phase_stem
    for name in int8_nodes:
        np.testing.assert_array_equal(env[name].numpy(), case["ref_env"][phase_stem][name],
                                      err_msg=name)


def test_every_int8_node_equals_reference(case):
    _every_int8_node_equals_reference(case, False)


def test_every_int8_node_equals_reference_phase_stem(case):
    _every_int8_node_equals_reference(case, True)


def test_plain_flag_gives_the_same_values(case):
    eng = _port_engine(case)
    x = torch.as_tensor(case["x"])
    np.testing.assert_array_equal(execute(eng.graph, plain=True)(eng.params, image=x).numpy(),
                                  case["ref_logits"])


def test_engine_graph_matches_reference_passes(case):
    """Packed pot4 stays packed (decoded on chip), the int8 stem takes the
    fused input quantize, and the rest of the graph is the reference's."""
    art = case["art"]
    eng = _port_engine(case)
    fmts = [n.attrs["wfmt"] for n in eng.graph.nodes if n.op in ("qconv2d", "qdense")]
    assert fmts.count("pot4") == 16 and fmts.count("int8") == 2
    ref_g, _ = ref_fuse_stem_quantize(art.graph, art.params)
    port_g, _ = fuse_stem_quantize(Graph.from_json(art.graph.to_json()), {})
    assert port_g.to_json() == ref_g.to_json()
    assert eng.graph.to_json() == port_g.to_json()
    stem = eng.graph.nodes[0]
    assert stem.op == "qconv2d" and "s_in" in stem.attrs and stem.inputs == ("image",)


@pytest.mark.parametrize("merge", [False, True])
def test_phase_stem_engine_graph_matches_reference(case, merge):
    """Engine(phase_stem=True, merge_1x1=m) against the reference's Engine
    with the same flags ((True, True) is its default): the same graph once
    the convs the port keeps packed are decoded too, the same packed stem
    weight, and with the merge every int8 node equal."""
    import json

    from tf2_tpu_torch.runtime.engine import _decode_pot4

    art = case["art"]
    g, p = from_reference(art.graph.to_json(), art.params)
    eng = Engine(g, p, device="cpu", phase_stem=True, merge_1x1=merge, block_fusion=False)
    ref = RefEngine(art.graph, art.params, phase_stem=True, merge_1x1=merge)
    params = {k: v.numpy() for k, v in eng.params.items()}
    pot4 = {n.name for n in eng.graph.nodes if n.attrs.get("wfmt") == "pot4"}
    decoded, _ = _decode_pot4(eng.graph, params, pot4)
    assert json.loads(decoded.to_json()) == json.loads(ref.graph.to_json())
    stem = eng.graph.nodes[0]
    assert stem.attrs["wfmt"] == "wpack2"
    np.testing.assert_array_equal(params[stem.params[0]], np.asarray(ref.params[stem.params[0]]))
    if merge:
        _, env = execute(eng.graph, intermediates=True)(eng.params,
                                                        image=torch.as_tensor(case["x"]))
        for n in eng.graph.nodes:
            if env[n.name].dtype == torch.int8:
                np.testing.assert_array_equal(env[n.name].numpy(), case["ref_env"][True][n.name],
                                              err_msg=n.name)


def test_predecode_decodes_what_kernels_cannot_take(case):
    """An odd-K pot4 conv and a grouped one are decoded to int8 at load."""
    from tf2_tpu_torch.runtime.engine import _predecode_fallback_weights
    from tf2_tpu_torch.transform import potq

    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    nodes = g.node_map()
    odd, grouped = nodes["s1b0_c2_relu"], nodes["s2b0_c2_relu"]
    codes = potq.unpack_codes_np(p[odd.params[0]], 3 * 3 * 64)
    odd.attrs["kshape"] = [3, 3, 63, 64]  # K = 567
    p[odd.params[0]] = potq.pack_codes(codes[:567])
    grouped.attrs["groups"] = 2
    g2, p2 = _predecode_fallback_weights(g, p)
    nodes2 = g2.node_map()
    for name in (odd.name, grouped.name):
        assert nodes2[name].attrs["wfmt"] == "int8"
        assert nodes2[name].params[0] == f"{name}.wq"
    np.testing.assert_array_equal(p2[f"{odd.name}.wq"],
                                  potq.pot_decode_np(codes[:567]).reshape(3, 3, 63, 64))
    assert sum(n.attrs.get("wfmt") == "pot4" for n in g2.nodes) == 14


def test_artifact_through_engine(case, tmp_path):
    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    save_artifact(str(tmp_path), g, p)
    g2, p2 = load_artifact(str(tmp_path))
    y = Engine(g2.with_batch_size(1), p2, device="cpu").run(image=case["x"][1:])
    np.testing.assert_array_equal(y.numpy(), case["ref_logits"][1:])


def test_cuda_engine_without_card_raises(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g, p = from_reference(case["art"].graph.to_json(), case["art"].params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(g, p)


def test_profile_summary(tmp_path):
    """The profiler summary: device busy time is the union of kernel
    intervals, the port's kernels are named by their wrappers, and
    "<op>:<node>" device ranges are summed by op."""
    import json

    from tf2_tpu_torch.runtime.profile import summarize

    k = ("void tf2::(anonymous namespace)::qgemm_kernel<(anonymous namespace)::{}>"
         "(tf2::(anonymous namespace)::Args)")
    events = [
        {"cat": "kernel", "name": k.format("qmatmul_pot4, 0, 1, true"), "ts": 0, "dur": 10},
        {"cat": "kernel", "name": k.format("qconv_s2, 1, 2, false"), "ts": 5, "dur": 10},
        {"cat": "kernel", "name": "void at::native::vectorized_elementwise_kernel<4, "
         "at::native::CUDAFunctor_add<float> >(int)", "ts": 30, "dur": 10},
        {"cat": "gpu_user_annotation", "name": "qadd:s1b0_add", "ts": 30, "dur": 12},
        {"cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = summarize(str(path), steps=2, wall_s=100e-6)
    assert s["wall_ms_per_forward"] == pytest.approx(0.05)
    assert s["device_busy_ms_per_forward"] == pytest.approx(0.0125)  # 25 us / 2
    assert s["idle_share"] == pytest.approx(0.75)
    assert list(s["by_family"]) == ["qmatmul_pot4", "qconv_s2",
                                    "torch:vectorized_elementwise_kernel"]
    assert s["by_family"]["qconv_s2"]["launches_per_forward"] == 0.5
    assert s["device_ms_by_op"] == {"qadd": pytest.approx(0.006)}


@pytest.mark.parametrize("hw,scale,s_out", [(7, 0.02, 0.02), (7, 0.0371, 0.0113),
                                            (2, 0.0137, 0.0059)])
def test_global_avgpool_matches_reference(hw, scale, s_out):
    """On dequantized int8 maps (ResNet-50's final 7x7 and the small
    model's 2x2): the port's mean is the float64 mean rounded once to f32
    (tolerance 0); the reference's f32 mean is within the error bound of an
    f32 sum (n * 2^-24 * sum|x|, over n and plus 1 ulp) of it; and the two
    are equal after the int8 quantize that follows the mean in the graph."""
    from tf2_tpu.graph.execute import _OP_IMPLS as REF_OPS
    from tf2_tpu_torch.graph import Node
    from tf2_tpu_torch.graph.execute import _OP_IMPLS

    q = np.random.default_rng(hw).integers(-127, 128, (2, hw, hw, 2048), dtype=np.int8)
    x = q.astype(np.float32) * np.float32(scale)
    gap = Node("gap", "global_avgpool", ("x",), (), {})
    quant = Node("q", "quantize", ("gap",), (), {"scale": s_out})
    got = _OP_IMPLS["global_avgpool"][0](gap, {}, torch.as_tensor(x))
    ref = REF_OPS["global_avgpool"](gap, {}, jnp.asarray(x))
    exact = (x.astype(np.float64).sum(axis=(1, 2)) / (hw * hw)).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)
    bound = 2.0 ** -24 * np.abs(x).sum(axis=(1, 2))
    np.testing.assert_array_less(np.abs(got.numpy() - np.asarray(ref)),
                                 bound + np.spacing(np.abs(exact)))
    np.testing.assert_array_equal(
        _OP_IMPLS["quantize"][0](quant, {}, got).numpy(),
        np.asarray(REF_OPS["quantize"](quant, {}, ref)))
