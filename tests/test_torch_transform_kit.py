"""The port's Transform Kit (quantizer options, bias correction, pipeline,
CLI) against tf2_tpu's on the CPU, on small models fed the same
numpy-seeded params and batches.

- ``quantize_graph`` from the reference's own scales (``bias_correct``
  off): the graph JSON and every tensor hash equal, on SqueezeNet W4 and
  W8, a depth-1 ResNet-50 W4, a one-block ViT W8 (``fold_residual``: a
  qdense with the residual in its epilogue), a small SSD, and SqueezeNet
  with ``equalize_concat=False``.
- ``bias_correct``: every tensor but the ``eb`` vectors keeps its hash and,
  given the reference's own f32 forward values, each ``eb`` lies within
  ``EB_QUANTA`` (1e-3 output quanta) of the reference's (largest measured:
  ``EB_MEASURED``). On the port's own forward the same holds for every
  node whose quantized replay inputs equal the reference's; an input
  element on a rounding boundary moves a node's mean by 1 / rows quanta
  (largest measured where the inputs agree: ``EB_MEASURED_OWN``).
- The CLI (``--platform cpu``) writes an artifact that loads (hashes
  verified) and runs; the reference's ``transform_model`` fed the same
  params and the CLI's own calibration batches (``cli.calibration_batches``)
  gives the same graph, equal weight hashes, activation scales within
  ``SCALE_RTOL`` (1e-5) and 99% of the ``eb`` entries within ``EB_QUANTA``
  (the rest, on rounding boundaries, within half a quantum). The reference's
  Engine on the port's artifact and the port's Engine equal node by node.
- The reference's pipeline tests (tests/transform/test_pipeline.py) with
  their budgets, on the port.
"""
import copy
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.optimize import patchify_stem as ref_patchify
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.models.ssd import init_priors as ref_init_priors
from tf2_tpu.runtime import Engine as RefEngine
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import load_artifact as ref_load_artifact
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu.transform import transform_model as ref_transform_model
from tf2_tpu.transform.bias_correct import bias_correct as ref_bias_correct
from tf2_tpu_torch import kernels
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.execute import _OP_IMPLS
from tf2_tpu_torch.graph.init_params import init_params
from tf2_tpu_torch.graph.optimize import patchify_stem
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import (PruneSpec, QuantSpec, fold_batch_norm, load_artifact,
                                     prune_params, quantize_graph, save_quantized,
                                     transform_model)
from tf2_tpu_torch.transform import cli
from tf2_tpu_torch.transform.bias_correct import bias_correct
from tf2_tpu_torch.transform.export import _hash

SCALE_RTOL = 1e-5
EB_QUANTA = 1e-3
# the largest |eb_port - eb_reference| in output quanta, measured on the CPU
# with these seeds: given the reference's f32 values (every case of
# test_bias_correction_matches_reference: the same bits), and on the port's
# own forward where the replay inputs agree (test_bias_correction_on_own_forward)
EB_MEASURED = 0.0
EB_MEASURED_OWN = 8.06e-5
# (model, builder kwargs, QuantSpec kwargs)
CASES = {
    "squeezenet_w4": ("squeezenet_v1_1", dict(batch=2, image=32, classes=10),
                      dict(weight_bits=4)),
    "squeezenet_w8": ("squeezenet_v1_1", dict(batch=2, image=32, classes=10),
                      dict(weight_bits=8)),
    "squeezenet_no_equalize": ("squeezenet_v1_1", dict(batch=2, image=32, classes=10),
                               dict(weight_bits=4, equalize_concat=False)),
    "resnet50_w4": ("resnet50", dict(batch=2, image=32, classes=10, depths=(1, 1, 1, 1)),
                    dict(weight_bits=4)),
    "vit_w8": ("vit_b16", dict(batch=2, image=32, classes=10, dim=64, depth=1, heads=4),
               dict(weight_bits=8)),
    "ssd_w4": ("ssd", dict(batch=1, image=64, classes=21), dict(weight_bits=4)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _hashes(params) -> dict[str, str]:
    return {k: _hash(np.asarray(v)) for k, v in params.items()}


def _jnp(batches):
    return [{k: jnp.asarray(np.asarray(v)) for k, v in b.items()} for b in batches]


@functools.lru_cache(maxsize=None)
def _case(name: str) -> dict:
    """Both packages' folded (and patchified) graphs of one model with the
    reference's params, two batches, the reference's percentile scales and
    its artifact without bias correction."""
    model, kw, spec = CASES[name]
    rg = ref_get_model(model, **kw)
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=0).items()}
    if model == "ssd":
        params.update({k: np.asarray(v) for k, v in ref_init_priors(rg).items()})
    rfg, rfp = ref_patchify(*ref_fold(rg, params))
    rfp = {k: np.asarray(v) for k, v in rfp.items()}
    fg, fp = patchify_stem(*fold_batch_norm(get_model(model, **kw), params))
    assert fg.to_json() == rfg.to_json()
    rng = np.random.default_rng(3)
    batches = [{"image": rng.standard_normal(rg.inputs["image"].shape).astype(np.float32)}
               for _ in range(2)]
    scales = ref_calibrate(rfg, rfp, _jnp(batches))
    ref_art = ref_quantize_graph(rfg, rfp, scales, RefQuantSpec(**spec, bias_correct=False))
    return dict(name=name, spec=spec, fg=fg, fp=fp, rfg=rfg, rfp=rfp,
                batches=batches, scales=scales, ref_art=ref_art)


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return _case(request.param)


def test_quantize_graph_from_reference_scales_equal_hashes(case):
    art = quantize_graph(case["fg"], case["fp"], case["scales"],
                         QuantSpec(**case["spec"], bias_correct=False))
    assert art.graph.to_json() == case["ref_art"].graph.to_json()
    assert _hashes(art.params) == _hashes(case["ref_art"].params)
    if case["name"] == "squeezenet_no_equalize":
        concats = [n for n in art.graph.nodes if n.op == "qconcat"]
        assert any(s != n.attrs["out_scale"] for n in concats for s in n.attrs["in_scales"])
    if case["name"] == "vit_w8":
        assert any(len(n.inputs) == 2 for n in art.graph.nodes if n.op == "qdense")


BIAS_CASES = ["squeezenet_w4", "resnet50_w4", "vit_w8", "ssd_w4"]


@functools.lru_cache(maxsize=None)
def _ref_corrected(name: str):
    """The reference's bias-corrected artifact of a case, its count of
    corrected layers and its f32 forward values of each batch (XLA,
    jitted)."""
    case = _case(name)
    ref_art = copy.deepcopy(case["ref_art"])
    ref_art.params = {k: np.asarray(v) for k, v in ref_art.params.items()}
    n = ref_bias_correct(ref_art, case["rfg"], case["rfp"], _jnp(case["batches"]))
    run = jax.jit(ref_execute(case["rfg"], intermediates=True))
    values = []
    for b in case["batches"]:
        _, env = run(case["rfp"], image=jnp.asarray(b["image"]))
        values.append({"image": b["image"], **{k: np.asarray(v) for k, v in env.items()}})
    return ref_art, n, values


@pytest.fixture(scope="module", params=BIAS_CASES)
def bias_case(request):
    return _case(request.param)


def _corrected(case, own: bool):
    """(port artifact, reference artifact, reference values), both
    bias-corrected; the port's on its own forward or on the reference's
    values."""
    ref_art, n_ref, values = _ref_corrected(case["name"])
    art = quantize_graph(case["fg"], case["fp"], case["scales"],
                         QuantSpec(**case["spec"], bias_correct=False))
    before = _hashes(art.params)
    n = bias_correct(art, case["fg"], case["fp"], case["batches"], device="cpu",
                     values=None if own else values)
    assert n == n_ref == sum(x.op in ("qconv2d", "qdense") for x in art.graph.nodes)
    eb = {k for k in art.params if k.endswith(".eb")}
    others = lambda p: {k: h for k, h in _hashes(p).items() if k not in eb}  # noqa: E731
    assert others(art.params) == others(ref_art.params) == \
        {k: h for k, h in before.items() if k not in eb}
    assert any(before[k] != _hash(art.params[k]) for k in eb)
    return art, ref_art, values


def _eb_diff(art, ref_art, node) -> float:
    k = node.params[2]
    return float(np.abs(art.params[k].astype(np.float64) - ref_art.params[k]).max())


def test_bias_correction_matches_reference(bias_case):
    """The port's teacher-forced replay (each node on the plain versions of
    the kernels) given the reference's own f32 forward values: the same
    count of corrected layers, every tensor but eb equal, each eb within
    EB_QUANTA output quanta of the reference's."""
    case = bias_case
    art, ref_art, _ = _corrected(case, own=False)
    worst = max(_eb_diff(art, ref_art, n) for n in art.graph.nodes
                if n.op in ("qconv2d", "qdense"))
    print(f"{case['name']}: largest |eb - eb_ref| {worst:.3g} quanta")
    assert worst <= EB_QUANTA


def test_bias_correction_on_own_forward(bias_case):
    """The same on the port's own forward (float64 convolutions rounded to
    f32, ``calibrate.forward_values``), which differs from XLA's f32 in the
    last bits: where a node's quantized replay inputs equal the reference's
    in every batch, its eb is within EB_QUANTA of the reference's. Where an
    input lies on a rounding boundary, one quantized element differs and the
    node's int8 replay outputs with it, each by one quantum in one row of
    the mean (1 / rows); those nodes are counted."""
    from tf2_tpu_torch.kernels.dispatch import quantize
    from tf2_tpu_torch.transform.bias_correct import _fp_name
    from tf2_tpu_torch.transform.calibrate import forward_values

    case = bias_case
    art, ref_art, ref = _corrected(case, own=True)
    tp = {k: torch.as_tensor(np.asarray(v)) for k, v in case["fp"].items()}
    own = [forward_values(case["fg"], tp, b) for b in case["batches"]]
    flipped, worst = [], 0.0
    for n in art.graph.nodes:
        if n.op not in ("qconv2d", "qdense"):
            continue
        s_in = float(n.attrs["in_scale"])
        same = True
        for i, s in zip(n.inputs, (s_in, float(n.attrs.get("radd_scale", 0)) *
                                   float(n.attrs["out_scale"]))):
            for a, b in zip(own, ref):
                same &= torch.equal(quantize(a[_fp_name(i)], s),
                                    quantize(torch.as_tensor(b[_fp_name(i)]), s))
        if same:
            worst = max(worst, _eb_diff(art, ref_art, n))
        else:
            flipped.append(n.name)
    print(f"{case['name']}: largest |eb - eb_ref| {worst:.3g} quanta where the replay "
          f"inputs agree; {len(flipped)} nodes with an input on a rounding boundary")
    assert worst <= EB_QUANTA


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The port's CLI on the CPU (SqueezeNet v1.1 W4, batch 2, image 32, 10
    classes), and the reference's transform_model on the same params and
    the CLI's own batches."""
    out = str(tmp_path_factory.mktemp("cli") / "art")
    argv = ["--model", "squeezenet_v1_1", "--wbits", "4", "--out", out, "--batch", "2",
            "--image", "32", "--classes", "10", "--calib-batches", "2", "--platform", "cpu"]
    report = {}
    assert cli.main(argv, report=report) == 0
    g = get_model("squeezenet_v1_1", batch=2, image=32, classes=10)
    batches = cli.calibration_batches(g.inputs["image"].shape, 2, seed=0)
    ref_art, _, _ = ref_transform_model(
        ref_get_model("squeezenet_v1_1", batch=2, image=32, classes=10),
        init_params(g, seed=0), _jnp([{k: v.numpy() for k, v in b.items()} for b in batches]),
        qspec=RefQuantSpec(weight_bits=4))
    return dict(out=out, report=report, ref_art=ref_art, batches=batches)


def test_cli_writes_an_artifact_that_runs(cli_run):
    graph, params = load_artifact(cli_run["out"])
    assert set(cli_run["report"]["stage_seconds"]) == {
        "prune", "fold", "calibrate", "quantize", "bias_correct", "save"}
    assert cli_run["report"]["compression"] > 1
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((2, 32, 32, 3)),
                        dtype=torch.float32)
    y = Engine(graph, params, device="cpu").run(image=x)
    assert y.shape == (2, 10) and bool(torch.isfinite(y).all())


def test_cli_batches_are_seeded_on_the_cpu():
    a = cli.calibration_batches((2, 8, 8, 3), 2, seed=4)
    b = cli.calibration_batches((2, 8, 8, 3), 2, seed=4)
    assert all(torch.equal(x["image"], y["image"]) for x, y in zip(a, b))
    assert not torch.equal(a[0]["image"], a[1]["image"])
    assert a[0]["image"].device.type == "cpu" and a[0]["image"].dtype == torch.float32


def test_cli_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--model", "squeezenet_v1_1", "--out", str(tmp_path / "a"), "--image", "32"])
    assert not (tmp_path / "a").exists()


def test_cli_artifact_matches_reference_transform_model(cli_run):
    """The same graph but for the scale attributes, which agree to
    SCALE_RTOL; equal hashes of every weight (codes, int8 weights); es
    within the product of the scales' tolerances. eb: each package corrects
    on its own forward, and where a replay input lies on a rounding
    boundary between the two forwards a node's mean moves by 1 / rows
    quanta (test_bias_correction_on_own_forward), so at least 99% of the
    eb entries lie within EB_QUANTA and every one within half a quantum."""
    graph, params = load_artifact(cli_run["out"])
    ref = cli_run["ref_art"]
    mine, theirs = json.loads(graph.to_json()), json.loads(ref.graph.to_json())
    scale_keys = ("in_scale", "out_scale", "in_scales", "s_in", "s_out", "radd_scale", "scale",
                  "sa", "sb", "so")
    worst = 0.0
    assert [n["name"] for n in mine["nodes"]] == [n["name"] for n in theirs["nodes"]]
    for a, b in zip(mine["nodes"], theirs["nodes"]):
        assert {k: v for k, v in a.items() if k != "attrs"} == \
            {k: v for k, v in b.items() if k != "attrs"}
        assert set(a["attrs"]) == set(b["attrs"])
        for k, v in a["attrs"].items():
            if k in scale_keys:
                got, want = np.asarray(v, np.float64), np.asarray(b["attrs"][k], np.float64)
                worst = max(worst, float((np.abs(got - want) / want).max()))
            else:
                assert v == b["attrs"][k], (a["name"], k)
    assert worst <= SCALE_RTOL, worst
    assert set(params) == set(ref.params)
    eb_diffs = []
    for k, v in params.items():
        want = np.asarray(ref.params[k])
        if k.endswith((".wp", ".wq")):
            assert _hash(v) == _hash(want), k
        elif k.endswith(".es"):
            np.testing.assert_allclose(v, want, rtol=3 * SCALE_RTOL, err_msg=k)
        elif k.endswith(".eb"):
            d = np.abs(v.astype(np.float64) - want)
            eb_diffs.append(d)
    d = np.concatenate(eb_diffs)
    print(f"eb: {int((d > EB_QUANTA).sum())} of {d.size} entries beyond {EB_QUANTA} quanta, "
          f"largest {d.max():.3g}")
    assert (d <= EB_QUANTA).mean() >= 0.99 and d.max() <= 0.5


def test_engine_on_cli_artifact_equals_reference_engine(cli_run):
    """The reference's default Engine (merge_1x1 and phase_stem on) on the
    port's artifact, loaded by the reference, and the port's Engine with
    the same flags: every int8 node fed the reference's inputs equal, and
    the logits' argmax."""
    rgraph, rparams = ref_load_artifact(cli_run["out"])
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = RefEngine(rgraph, rparams)
    _, env = jax.jit(ref_execute(ref.graph, intermediates=True))(ref.params,
                                                                 image=jnp.asarray(x))
    env = {k: np.asarray(v) for k, v in env.items()}
    graph, params = load_artifact(cli_run["out"])
    eng = Engine(graph, params, device="cpu", merge_1x1=True, phase_stem=True,
                 block_fusion=False)
    checked = 0
    for n in eng.graph.nodes:
        if n.name not in env or env[n.name].dtype != np.int8:
            continue
        impl, takes_kernel = _OP_IMPLS[n.op]
        args = [torch.tensor(env[i]) for i in n.inputs]
        got = (impl(n, eng.params, *args, kernel=None) if takes_kernel
               else impl(n, eng.params, *args)).numpy()
        np.testing.assert_array_equal(got, env[n.name], err_msg=n.name)
        checked += 1
    assert checked >= 30
    kernels.reset_launch_counts()
    y = eng.run(image=x).numpy()
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_array_equal(y.argmax(1), np.asarray(ref.run(image=x)).argmax(1))


# ---- the reference's pipeline tests (tests/transform/test_pipeline.py) ----

def _rand_batches(g, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": torch.as_tensor(rng.standard_normal(g.inputs["image"].shape),
                                      dtype=torch.float32)} for _ in range(n)]


def _tensors(params):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}


def _relative_err(ref, x):
    ref, x = np.asarray(ref, np.float64), np.asarray(x, np.float64)
    return float(np.linalg.norm(x - ref) / (np.linalg.norm(ref) + 1e-12))


@pytest.mark.parametrize("model,wbits", [("squeezenet_v1_1", 8), ("squeezenet_v1_1", 4),
                                         ("resnet50", 4)])
def test_quantized_golden_parity(model, wbits):
    """The quantized forward tracks the f32 forward within the reference
    test's budgets (random weights: 0.15 at W8, 0.85 at W4; cosine above
    0.9 and 0.5)."""
    kwargs = dict(batch=2, image=32, classes=10)
    if model == "resnet50":
        kwargs["depths"] = (1, 1, 1, 1)
    g = get_model(model, **kwargs)
    art, fg, fp = transform_model(g, init_params(g, seed=0), _rand_batches(g, 2),
                                  qspec=QuantSpec(weight_bits=wbits), device="cpu")
    x = _rand_batches(g, 1, seed=9)[0]["image"]
    y_fp = execute(fg)(_tensors(fp), image=x).numpy()
    y_q = execute(art.graph)(_tensors(art.params), image=x).numpy()
    assert y_q.dtype == np.float32
    err = _relative_err(y_fp, y_q)
    assert err < (0.15 if wbits == 8 else 0.85), err
    cos = float((y_fp.ravel() @ y_q.ravel()) /
                (np.linalg.norm(y_fp) * np.linalg.norm(y_q) + 1e-12))
    assert cos > (0.9 if wbits == 8 else 0.5)


def test_quantized_graph_structure():
    g = get_model("squeezenet_v1_1", batch=1, image=32, classes=10)
    art, fg, fp = transform_model(g, init_params(g), _rand_batches(g, 1), device="cpu")
    ops = {n.op for n in art.graph.nodes}
    assert "qconv2d" in ops and "qconcat" in ops
    assert "conv2d" not in ops
    qconvs = [n for n in art.graph.nodes if n.op == "qconv2d"]
    assert qconvs[0].attrs["wfmt"] == "int8"
    assert qconvs[-1].attrs["wfmt"] == "int8"
    assert any(n.attrs["wfmt"] == "pot4" for n in qconvs)
    fp_bytes = sum(int(np.prod(v.shape)) * 4 for v in fp.values())
    assert art.size_bytes() < fp_bytes / 2


def test_artifact_save_load_roundtrip(tmp_path):
    g = get_model("squeezenet_v1_1", batch=1, image=32, classes=10)
    art, fg, fp = transform_model(g, init_params(g), _rand_batches(g, 1), device="cpu")
    save_quantized(str(tmp_path / "art"), art)
    g2, p2 = load_artifact(str(tmp_path / "art"))
    x = torch.ones(g.inputs["image"].shape)
    y1 = execute(art.graph)(_tensors(art.params), image=x)
    y2 = execute(g2)(_tensors(p2), image=x)
    assert torch.equal(y1, y2)


def test_prune_masks_channels():
    g = get_model("squeezenet_v1_1", batch=1, image=32, classes=10)
    pruned, report = prune_params(g, init_params(g), PruneSpec(fraction=0.25))
    assert report
    w = np.asarray(pruned[f"{next(iter(report))}.w"])
    assert (np.abs(w).reshape(-1, w.shape[-1]).sum(0) == 0).mean() >= 0.2


def test_bias_correction_reduces_error():
    """The reference test's bar: bias correction cuts the W4 output error
    below 0.6 of the uncorrected one on a seeded depth-1 ResNet-50."""
    g = get_model("resnet50", batch=2, image=64, classes=50, depths=(1, 1, 1, 1))
    params = init_params(g, seed=0)
    batches = _rand_batches(g, 2, seed=1)
    x = _rand_batches(g, 1, seed=9)[0]["image"]
    errs = {}
    for bc in (False, True):
        art, fg, fp = transform_model(g, params, batches, device="cpu",
                                      qspec=QuantSpec(weight_bits=4, bias_correct=bc))
        yf = execute(fg)(_tensors(fp), image=x).numpy()
        yq = execute(art.graph)(_tensors(art.params), image=x).numpy()
        errs[bc] = float(np.linalg.norm(yq - yf) / np.linalg.norm(yf))
    assert errs[True] < errs[False] * 0.6, errs
