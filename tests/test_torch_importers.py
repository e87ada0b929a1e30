"""The port's importers, Caffe reader and pruning against tf2_tpu's on the
CPU, on the state dicts and ``.caffemodel`` bytes the reference's own tests
build (tests/transform/test_importers.py, test_caffe.py, test_prune.py):
every imported param equal to the reference's, bit for bit; the forward of
an imported model finite; the pruned graph and params equal.

Also: ``load_checkpoint`` on ``.safetensors``, ``.npz`` and ``.pth`` files,
the reference's fault at ``tf2_tpu/transform/importers.py:287`` (a square
torch ``Linear`` loads untransposed), reproduced and pinned, and the guard
that no module of the port imports JAX or tf2_tpu.
"""
import ast
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.graph.ir import GraphBuilder as RefBuilder
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.transform import caffe as ref_caffe
from tf2_tpu.transform import importers as ref_importers
from tf2_tpu.transform.prune import PruneSpec as RefPruneSpec
from tf2_tpu.transform.prune import prune_channels as ref_prune_channels
from tf2_tpu.transform.prune import prune_params as ref_prune_params
from tf2_tpu_torch.graph import GraphBuilder, execute
from tf2_tpu_torch.graph.shapes import activation_shapes
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.transform import caffe, importers
from tf2_tpu_torch.transform.export import write_safetensors
from tf2_tpu_torch.transform.prune import PruneSpec, channel_l1, prune_channels, prune_params

TESTS = pathlib.Path(__file__).resolve().parent
REPO = TESTS.parent


def _load(name: str):
    """A module of the reference's tests, by path (tests/ is no package)."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", TESTS / "transform" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_IMPORTERS = _load("test_importers")
REF_CAFFE = _load("test_caffe")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        a, b = np.asarray(got[k]), np.asarray(v)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _forward_finite(graph, params, classes=1000):
    x = torch.ones(tuple(graph.inputs["image"].shape))
    out = execute(graph)({k: torch.as_tensor(np.asarray(v)) for k, v in params.items()},
                         image=x)
    assert out.shape == (1, classes) and bool(torch.isfinite(out).all())


def test_import_torchvision_resnet50_matches_reference():
    state = REF_IMPORTERS._fake_tv_resnet50_state()
    g = get_model("resnet50", batch=1, image=64)
    got = importers.import_torchvision_resnet50(state, g)
    _equal(got, ref_importers.import_torchvision_resnet50(state, ref_get_model("resnet50", batch=1,
                                                                             image=64)))
    assert got["conv1.w"].shape == (7, 7, 3, 64) and got["fc.w"].shape == (2048, 1000)
    _forward_finite(g, got)


def test_import_torchvision_resnet50_from_torch_tensors():
    """A state dict of torch tensors (what ``torch.load`` gives) imports as
    the same numpy arrays."""
    state = REF_IMPORTERS._fake_tv_resnet50_state()
    g = get_model("resnet50", batch=1, image=224)
    _equal(importers.import_torchvision_resnet50(
        {k: torch.from_numpy(v) for k, v in state.items()}, g),
        importers.import_torchvision_resnet50(state, g))


def test_import_rejects_wrong_shape_and_missing():
    g = get_model("resnet50", batch=1, image=224)
    state = REF_IMPORTERS._fake_tv_resnet50_state()
    state["fc.weight"] = state["fc.weight"][:, :100]
    with pytest.raises(ValueError, match="shape mismatch|missing"):
        importers.import_torchvision_resnet50(state, g)
    with pytest.raises(ValueError, match="missing"):
        importers.import_flat({}, get_model("squeezenet_v1_1", batch=1, image=64))


def test_import_torchvision_squeezenet_matches_reference():
    state = REF_IMPORTERS._fake_tv_squeezenet_state()
    g = get_model("squeezenet_v1_1", batch=1, image=64)
    got = importers.import_torchvision_squeezenet1_1(state, g)
    _equal(got, ref_importers.import_torchvision_squeezenet1_1(
        state, ref_get_model("squeezenet_v1_1", batch=1, image=64)))
    _forward_finite(g, got)


def test_import_torchvision_googlenet_matches_reference():
    """BN folded into each conv in float64 and the 3x3 branch zero-padded to
    5x5, bit for bit as the reference."""
    state = REF_IMPORTERS._fake_tv_googlenet_state()
    g = get_model("googlenet", batch=1, image=64)
    got = importers.import_torchvision_googlenet(state, g)
    _equal(got, ref_importers.import_torchvision_googlenet(
        state, ref_get_model("googlenet", batch=1, image=64)))
    assert got["inc3a_5x5.w"].shape == (5, 5, 16, 32)
    _forward_finite(g, got)


def test_import_keras_resnet50_matches_reference():
    g = get_model("resnet50", batch=1, image=64)
    weights = REF_IMPORTERS._fake_keras_resnet50_weights(ref_get_model("resnet50", batch=1,
                                                                        image=64))
    got = importers.import_keras_resnet50(weights, g)
    _equal(got, ref_importers.import_keras_resnet50(weights, g))
    np.testing.assert_array_equal(got["conv1_bn.mean"],
                                  weights["conv1_bn/moving_mean"] - weights["conv1_conv/bias"])
    _forward_finite(g, got)


@pytest.mark.parametrize("model", ["vit_b16", "vit_b16_cls"])
@pytest.mark.parametrize("mlp_naming", ["linear", "indexed"])
def test_import_torchvision_vit_b16_matches_reference(model, mlp_naming):
    state = REF_IMPORTERS._fake_tv_vit_b16_state(mlp_naming)
    got = importers.import_torchvision_vit_b16(state, get_model(model, batch=1, image=224))
    _equal(got, ref_importers.import_torchvision_vit_b16(state, ref_get_model(model, batch=1,
                                                                            image=224)))
    t = 196 if model == "vit_b16" else 197
    np.testing.assert_array_equal(got["pos_embed"], state["encoder.pos_embedding"][:, -t:, :])


def test_import_torch_ssd_matches_reference():
    g, rg = get_model("ssd", batch=1, image=256), ref_get_model("ssd", batch=1, image=256)
    state = REF_IMPORTERS._fake_torch_ssd_state(rg)
    got = importers.import_torch_ssd(state, g)
    _equal(got, ref_importers.import_torch_ssd(state, rg))
    assert got["priors"].shape == tuple(g.params["priors"].shape)


def _square_linear_graph(builder):
    b = builder("mlp")
    x = b.input("image", (1, 48))
    x = b.relu(b.dense(x, 48, 48, name="fc"))
    return b.build(b.dense(x, 48, 10, name="head"))


def test_square_linear_loads_untransposed_as_the_reference():
    """The reference's fault (``tf2_tpu/transform/importers.py:287``):
    ``import_torch_named`` transposes a 2-D torch ``Linear`` weight only
    when its (out, in) shape differs from the graph's (in, out), so a
    square one loads untransposed. Reproduced as it is: the port's params
    equal the reference's, the square weight is the torch weight itself,
    and the non-square one its transpose."""
    rng = np.random.default_rng(0)
    state = {"fc.weight": rng.standard_normal((48, 48)).astype(np.float32),
             "fc.bias": rng.standard_normal(48).astype(np.float32),
             "head.weight": rng.standard_normal((10, 48)).astype(np.float32),
             "head.bias": rng.standard_normal(10).astype(np.float32)}
    got = importers.import_torch_named(state, _square_linear_graph(GraphBuilder))
    _equal(got, ref_importers.import_torch_named(state, _square_linear_graph(RefBuilder)))
    np.testing.assert_array_equal(got["fc.w"], state["fc.weight"])
    assert not np.array_equal(got["fc.w"], state["fc.weight"].T)
    np.testing.assert_array_equal(got["head.w"], state["head.weight"].T)


def test_fold_bn_and_pad_kernel_match_reference():
    rng = np.random.RandomState(3)
    args = (rng.randn(8, 4, 3, 3).astype(np.float32), np.abs(rng.randn(8)).astype(np.float32),
            rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32),
            np.abs(rng.randn(8)).astype(np.float32) + 0.5)
    for a, b in zip(importers._fold_bn_into_conv(*args), ref_importers._fold_bn_into_conv(*args)):
        np.testing.assert_array_equal(a, b)
    w3 = rng.randn(6, 5, 3, 3).astype(np.float32)
    np.testing.assert_array_equal(importers._pad_kernel_center(w3, 5, 5),
                                  ref_importers._pad_kernel_center(w3, 5, 5))


# ---- load_checkpoint ----

def _squeezenet_files(tmp_path):
    """One torchvision SqueezeNet state dict written as .pth (nested under
    ``state_dict``), .npz and .safetensors, and a flat dict of the graph's
    own names as .safetensors."""
    state = REF_IMPORTERS._fake_tv_squeezenet_state()
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()}},
               tmp_path / "sq.pth")
    np.savez(tmp_path / "sq.npz", **state)
    write_safetensors(str(tmp_path / "sq.safetensors"), state)
    g = get_model("squeezenet_v1_1", batch=1, image=64)
    flat = importers.import_torchvision_squeezenet1_1(state, g)
    write_safetensors(str(tmp_path / "flat.safetensors"), flat)
    return state, flat


@pytest.mark.parametrize("name", ["sq.pth", "sq.npz", "sq.safetensors", "flat.safetensors"])
def test_load_checkpoint_matches_reference(tmp_path, name):
    state, flat = _squeezenet_files(tmp_path)
    g = get_model("squeezenet_v1_1", batch=1, image=64)
    got = importers.load_checkpoint(str(tmp_path / name), g)
    _equal(got, ref_importers.load_checkpoint(
        str(tmp_path / name), ref_get_model("squeezenet_v1_1", batch=1, image=64)))
    _equal(got, flat)


def test_load_checkpoint_caffemodel_and_unknown(tmp_path):
    g = get_model("squeezenet_v1_1", batch=1, image=64)
    (tmp_path / "sq.caffemodel").write_bytes(
        REF_CAFFE._synth_caffemodel(caffe.squeezenet_v1_1_name_map(), g))
    got = importers.load_checkpoint(str(tmp_path / "sq.caffemodel"), g)
    _equal(got, ref_importers.load_checkpoint(str(tmp_path / "sq.caffemodel"),
                                              ref_get_model("squeezenet_v1_1", batch=1,
                                                            image=64)))
    np.savez(tmp_path / "odd.npz", **{"whatever.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="cannot infer importer"):
        importers.load_checkpoint(str(tmp_path / "odd.npz"), _square_linear_graph(GraphBuilder))


# ---- caffe ----

def test_caffe_roundtrip_and_reference_bytes():
    """write_caffemodel gives the reference's bytes, and parse_caffemodel
    reads them back as the reference does."""
    rng = np.random.RandomState(0)
    layers = {"conv1": {"type": "Convolution",
                        "blobs": [rng.randn(8, 3, 3, 3).astype(np.float32),
                                  rng.randn(8).astype(np.float32)]},
              "fc": {"type": "InnerProduct",
                     "blobs": [rng.randn(10, 32).astype(np.float32),
                               rng.randn(10).astype(np.float32)]}}
    data = caffe.write_caffemodel(layers)
    assert data == ref_caffe.write_caffemodel(layers)
    got, want = caffe.parse_caffemodel(data), ref_caffe.parse_caffemodel(data)
    assert set(got) == set(want) == {"conv1", "fc"}
    for k in got:
        assert got[k]["type"] == want[k]["type"]
        for a, b, c in zip(got[k]["blobs"], want[k]["blobs"], layers[k]["blobs"]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_caffe_legacy_v1_layers():
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 2, 2)
    blob = b""
    for f, v in ((1, 2), (2, 3), (3, 2), (4, 2)):
        blob += caffe._varint(f << 3 | 0) + caffe._varint(v)
    blob += caffe._ld(5, w.tobytes())
    layer = caffe._ld(1, b"conv_legacy") + caffe._varint(5 << 3 | 0) + caffe._varint(4)
    net = caffe._ld(2, layer + caffe._ld(6, blob))
    parsed = caffe.parse_caffemodel(net)
    assert parsed["conv_legacy"]["type"] == "Convolution"
    np.testing.assert_array_equal(parsed["conv_legacy"]["blobs"][0], w)
    np.testing.assert_array_equal(parsed["conv_legacy"]["blobs"][0],
                                  ref_caffe.parse_caffemodel(net)["conv_legacy"]["blobs"][0])


@pytest.mark.parametrize("model", ["squeezenet_v1_1", "googlenet"])
def test_import_caffe_matches_reference(model):
    g = get_model(model, batch=1, image=64)
    nm = (caffe.squeezenet_v1_1_name_map() if model == "squeezenet_v1_1"
          else caffe.googlenet_name_map())
    assert nm == (ref_caffe.squeezenet_v1_1_name_map() if model == "squeezenet_v1_1"
                  else ref_caffe.googlenet_name_map())
    fc = {"fc"} if model == "googlenet" else set()
    data = REF_CAFFE._synth_caffemodel(nm, g, fc_names=fc)
    got = caffe.import_caffe(caffe.parse_caffemodel(data), g, nm, fc_names=fc)
    _equal(got, ref_caffe.import_caffe(ref_caffe.parse_caffemodel(data),
                                       ref_get_model(model, batch=1, image=64), nm, fc_names=fc))
    _forward_finite(g, got)
    with pytest.raises(ValueError, match="missing layer"):
        caffe.import_caffe({}, g, nm)


# ---- prune ----

PRUNE_CASES = {"resnet50": dict(batch=2, image=32, depths=(1, 1, 1, 1), classes=10),
               "squeezenet_v1_1": dict(batch=2, image=64, classes=10)}


@pytest.mark.parametrize("model", list(PRUNE_CASES))
@pytest.mark.parametrize("fraction", [0.0, 0.25, 0.3])
def test_prune_channels_matches_reference(model, fraction):
    """The pruned graph JSON, params and report equal the reference's;
    every pruned width is a multiple of 8 (``round_to``)."""
    rg = ref_get_model(model, **PRUNE_CASES[model])
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=3).items()}
    g2, p2, report = prune_channels(get_model(model, **PRUNE_CASES[model]), params,
                                    PruneSpec(fraction=fraction))
    rg2, rp2, rreport = ref_prune_channels(rg, params, RefPruneSpec(fraction=fraction))
    assert g2.to_json() == rg2.to_json()
    _equal(p2, rp2)
    assert report == rreport
    assert bool(report) == (fraction > 0)
    for n in g2.nodes:
        if n.name in report:
            assert p2[n.params[0]].shape[-1] % 8 == 0
    assert activation_shapes(g2, p2)


@pytest.mark.parametrize("only", [False, True])
def test_prune_params_matches_reference(only):
    rg = ref_get_model("squeezenet_v1_1", **PRUNE_CASES["squeezenet_v1_1"])
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=5).items()}
    g = get_model("squeezenet_v1_1", **PRUNE_CASES["squeezenet_v1_1"])
    keep = {"fire3_squeeze", "fire5_e1x1"} if only else None
    got, report = prune_params(g, params, PruneSpec(fraction=0.25), only=keep)
    want, rreport = ref_prune_params(rg, params, RefPruneSpec(fraction=0.25), only=keep)
    _equal(got, {k: np.asarray(v) for k, v in want.items()})
    assert report == rreport and report
    w = np.asarray(got[f"{next(iter(report))}.w"])
    assert (channel_l1(w) == 0).mean() >= 0.2


# ---- the port imports neither JAX nor tf2_tpu ----

def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_neither_jax_nor_the_reference():
    """Every module of tf2_tpu_torch, and chip_smoke.py, at any depth of
    its code (imports inside functions too)."""
    files = sorted((REPO / "tf2_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 40
    bad = {f"{f.relative_to(REPO)}: {m}" for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "tf2_tpu")}
    assert not bad, sorted(bad)
