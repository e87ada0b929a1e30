"""The kernel each node of the zoo runs on the card, pinned: for every zoo
model the perfbench cells and chip_smoke.py build (ResNet-50 with and
without block fusion, GoogLeNet, SqueezeNet 1.1, ViT-B/16 with and without
the class token, SSD, ConvNeXt-T), one ViT with every GEMM on ``library``
(``dispatch.set_use_kernels(False)``) and the coverage graphs outside the
zoo, at batch 64 and 1: the count of nodes on each kernel and the exact
nodes left plain, on the stem kernel and on ``library``. The Engine is
loaded on the CPU with the H100's routing table and planned with the
H100's limits written out; the shapes are ``activation_shapes`` on
``meta`` tensors. Each artifact is built once (full size: 224x224, SSD
256x256)."""
import functools
from collections import Counter

import pytest
import torch

from tf2_tpu_torch.bench import coverage_cases
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.execute import run_node
from tf2_tpu_torch.kernels import autotune, dispatch
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime.engine import Engine, Limits

# qlrn.max_channels() and the chain kernel's shared memory on the H100
H100 = Limits(qlrn_channels=(48 * 1024 - 64) // 6, smem_per_block=232448)

ARTIFACTS = {
    "resnet50": lambda: synthetic_quantized("resnet50", batch=1),
    "googlenet": lambda: synthetic_quantized("googlenet", batch=1),
    "squeezenet_v1_1": lambda: synthetic_quantized("squeezenet_v1_1", batch=1),
    "vit_b16": lambda: synthetic_quantized("vit_b16", batch=1, weight_bits=8),
    "vit_b16_cls": lambda: synthetic_quantized("vit_b16_cls", batch=1, weight_bits=8),
    "ssd": lambda: synthetic_quantized("ssd", batch=1),
    "convnext_t": lambda: synthetic_quantized("convnext_t", batch=1),
    "coverage_convs": lambda: coverage_cases.conv_artifact(batch=1),
    "coverage_vit_hd24": lambda: coverage_cases.tiny_vit_hd24(batch=1),
    "coverage_stem_k9": lambda: coverage_cases.stem_artifact(9, 64, batch=1),
    "coverage_stem_co288": lambda: coverage_cases.stem_artifact(7, 288, batch=1),
}

# case -> (artifact, Engine options, set_use_kernels)
CASES = {
    "resnet50": ("resnet50", {}, None),
    "resnet50_unfused": ("resnet50", {"block_fusion": False}, None),
    "googlenet": ("googlenet", {}, None),
    "squeezenet_v1_1": ("squeezenet_v1_1", {}, None),
    "vit_b16": ("vit_b16", {}, None),
    "vit_b16_library": ("vit_b16", {}, False),
    "vit_b16_cls": ("vit_b16_cls", {}, None),
    "ssd": ("ssd", {}, None),
    "convnext_t": ("convnext_t", {}, None),
    "coverage_convs": ("coverage_convs", {}, None),
    "coverage_vit_hd24": ("coverage_vit_hd24", {}, None),
    "coverage_stem_k9": ("coverage_stem_k9", {}, None),
    "coverage_stem_co288": ("coverage_stem_co288", {}, None),
}

VIT_GEMMS = tuple(sorted([f"blk{i}_{s}" for i in range(12) for s in ("mlp1", "qkv", "res1", "res2")]
                         + ["head", "patch_embed"]))

# (case, batch) -> (nodes per kernel, plain nodes, stem nodes, library nodes),
# as the plan stood before it was made in one function
EXPECTED = {
    ("convnext_t", 64): (
        {"qdwconv": 18, "qgelu": 18, "qlayernorm": 23, "qmatmul_int8": 2, "qmatmul_pot4": 39},
        (), (), ()),
    ("convnext_t", 1): (
        {"qdwconv": 18, "qgelu": 18, "qlayernorm": 23, "qmatmul_int8": 2, "qmatmul_pot4": 39},
        (), (), ()),
    ("coverage_convs", 64): (
        {"plain": 3, "qdwconv": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1, "qstem": 1},
        ("g2_3x3", "s12_3x3", "s3_3x3"), ("stem",), ()),
    ("coverage_convs", 1): (
        {"plain": 3, "qdwconv": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1, "qstem": 1},
        ("g2_3x3", "s12_3x3", "s3_3x3"), ("stem",), ()),
    ("coverage_stem_co288", 64): (
        {"qconv_s2": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1},
        (), (), ()),
    ("coverage_stem_co288", 1): (
        {"qconv_s2": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1},
        (), (), ()),
    ("coverage_stem_k9", 64): (
        {"qconv_s2": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1},
        (), (), ()),
    ("coverage_stem_k9", 1): (
        {"qconv_s2": 1, "qmatmul_int8": 1, "qmatmul_pot4": 1},
        (), (), ()),
    ("coverage_vit_hd24", 64): (
        {"plain": 1, "qgelu": 1, "qlayernorm": 3, "qmatmul_int8": 6},
        ("blk0_attn",), (), ()),
    ("coverage_vit_hd24", 1): (
        {"plain": 1, "qgelu": 1, "qlayernorm": 3, "qmatmul_int8": 6},
        ("blk0_attn",), (), ()),
    ("googlenet", 64): (
        {"qconv_s1": 19, "qlrn": 2, "qmatmul_int8": 8, "qmatmul_pot4": 30, "qstem": 1},
        (), ("relu_0",), ()),
    ("googlenet", 1): (
        {"qconv_s1": 19, "qlrn": 2, "qmatmul_int8": 36, "qmatmul_pot4": 2, "qstem": 1},
        (), ("relu_0",), ()),
    ("resnet50", 64): (
        {"qblockchain": 4, "qconv_s2": 6, "qmatmul_int8": 1, "qmatmul_pot4": 6, "qstem": 1},
        (), ("conv1_relu",), ()),
    ("resnet50", 1): (
        {"qblockchain": 4, "qconv_s2": 6, "qmatmul_int8": 1, "qmatmul_pot4": 6, "qstem": 1},
        (), ("conv1_relu",), ()),
    ("resnet50_unfused", 64): (
        {"qconv_s1": 13, "qconv_s2": 6, "qmatmul_int8": 1, "qmatmul_pot4": 33, "qstem": 1},
        (), ("conv1_relu",), ()),
    ("resnet50_unfused", 1): (
        {"qconv_s1": 13, "qconv_s2": 6, "qmatmul_int8": 1, "qmatmul_pot4": 33, "qstem": 1},
        (), ("conv1_relu",), ()),
    ("squeezenet_v1_1", 64): (
        {"qconv_s1": 8, "qmatmul_int8": 1, "qmatmul_pot4": 16, "qstem": 1},
        (), ("relu_0",), ()),
    ("squeezenet_v1_1", 1): (
        {"qconv_s1": 8, "qmatmul_int8": 9, "qmatmul_pot4": 8, "qstem": 1},
        (), ("relu_0",), ()),
    ("ssd", 64): (
        {"qconv_s1": 8, "qconv_s2": 5, "qstem": 1},
        (), ("stem_relu",), ()),
    ("ssd", 1): (
        {"qconv_s1": 8, "qconv_s2": 5, "qstem": 1},
        (), ("stem_relu",), ()),
    ("vit_b16", 64): (
        {"qattention": 12, "qgelu": 12, "qlayernorm": 25, "qmatmul_int8": 50},
        (), (), ()),
    ("vit_b16", 1): (
        {"qattention": 12, "qgelu": 12, "qlayernorm": 25, "qmatmul_int8": 50},
        (), (), ()),
    ("vit_b16_cls", 64): (
        {"qattention": 12, "qgelu": 12, "qlayernorm": 25, "qmatmul_int8": 50},
        (), (), ()),
    ("vit_b16_cls", 1): (
        {"qattention": 12, "qgelu": 12, "qlayernorm": 25, "qmatmul_int8": 50},
        (), (), ()),
    ("vit_b16_library", 64): (
        {"library": 50, "qattention": 12, "qgelu": 12, "qlayernorm": 25},
        (), (), VIT_GEMMS),
    ("vit_b16_library", 1): (
        {"library": 50, "qattention": 12, "qgelu": 12, "qlayernorm": 25},
        (), (), VIT_GEMMS),
}


@functools.cache
def _artifact(name):
    return ARTIFACTS[name]()


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def h100_routes():
    """The H100's committed routing table, as an H100 without a tuned
    table reads it."""
    autotune.set_table_path(autotune.default_path("sm90"))
    try:
        yield
    finally:
        autotune.set_table_path(None)


def _plan(eng):
    """(nodes per kernel, plain, stem and library nodes) of the Engine's
    graph planned for the H100, with the routes it was loaded with."""
    kernels = Engine.plan(eng.graph, eng.params, H100, routes=eng.routes)
    assert dispatch.nodes_on(kernels, "library") == eng.library_nodes  # the CPU's plan
    return (dict(sorted(Counter(kernels.values()).items())),
            *(tuple(sorted(dispatch.nodes_on(kernels, k))) for k in ("plain", "qstem", "library")))


@pytest.mark.parametrize("batch", [64, 1], ids=["b64", "b1"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plan_is_pinned(h100_routes, case, batch):
    name, options, use_kernels = CASES[case]
    art = _artifact(name)
    graph = art.graph.with_batch_size(batch)
    dispatch.set_use_kernels(use_kernels)
    try:
        eng = Engine(graph, art.params, device="cpu", **options)
    finally:
        dispatch.set_use_kernels(None)
    assert _plan(eng) == EXPECTED[case, batch]


# ---- the executors run what the plan names ----

SMALL = {
    "resnet": lambda: synthetic_quantized("resnet50", batch=1, image=64, depths=(1, 1, 1, 1),
                                          classes=10),
    "googlenet": lambda: synthetic_quantized("googlenet", batch=1, image=64, classes=10),
    "vit": lambda: synthetic_quantized("vit_b16", batch=1, image=32, classes=10, dim=64,
                                       depth=2, heads=2, weight_bits=8),
    "convnext": lambda: synthetic_quantized("convnext_t", batch=1, image=32, classes=10,
                                            depths=(1, 1, 2, 1), dims=(16, 32, 64, 128)),
    "coverage_convs": lambda: coverage_cases.conv_artifact(batch=1),
    "coverage_vit_hd24": lambda: coverage_cases.tiny_vit_hd24(batch=1),
    "coverage_stem_k9": lambda: coverage_cases.stem_artifact(9, 64, batch=1),
}
# what each kernel's launch goes through: (module, function) -> kernel name
WRAPPERS = {("shift_matmul", "qmatmul_int8"): "qmatmul_int8",
            ("shift_matmul", "qmatmul_pot4"): "qmatmul_pot4",
            ("qconv", "qconv_s1"): "qconv_s1", ("qconv", "qconv_s2"): "qconv_s2",
            ("qconv", "qconv_s2x1"): "qconv_s2x1", ("qdwconv", "qdwconv"): "qdwconv",
            ("qstem", "fused_qstem"): "qstem", ("qattention", "qattention"): "qattention",
            ("qlayernorm", "qlayernorm"): "qlayernorm", ("qlrn", "qlrn"): "qlrn",
            ("qblocks", "qblockchain"): "qblockchain", ("qgelu", "qgelu"): "qgelu"}


@functools.cache
def _small(name):
    return SMALL[name]()


@pytest.mark.parametrize("options", [{}, {"block_fusion": False}, {"phase_stem": True}],
                         ids=["default", "unfused", "phase_stem"])
@pytest.mark.parametrize("name", sorted(SMALL))
def test_execute_runs_what_the_plan_names(name, options, monkeypatch):
    """A forward through ``execute(kernels=plan)`` enters each kernel's
    wrapper once for each node the H100's plan puts on it, and no other
    (here each wrapper takes its plain version), with the Engine's output."""
    import importlib

    art = _small(name)
    eng = Engine(art.graph, art.params, device="cpu", **options)
    plan = Engine.plan(eng.graph, eng.params, H100, routes=eng.routes)
    entered = []
    for (module, fn), kernel in WRAPPERS.items():
        mod = importlib.import_module(f"tf2_tpu_torch.kernels.{module}")

        def spy(*a, _real=getattr(mod, fn), _kernel=kernel, **kw):
            entered.append(_kernel)
            return _real(*a, **kw)

        monkeypatch.setattr(mod, fn, spy)
    x = torch.randn(tuple(eng.graph.inputs["image"].shape),
                    generator=torch.Generator().manual_seed(0))
    got = execute(eng.graph, kernels=plan)(eng.params, image=x)
    assert Counter(entered) == Counter(k for k in plan.values() if k not in ("plain", "library"))
    want = eng.run(image=x)
    for g, w in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case,nodes", [("coverage_convs", sorted(coverage_cases.CONV_PLAIN)),
                                        ("coverage_vit_hd24", ["blk0_attn"])])
def test_no_plan_on_the_card_raises_for_a_plain_node(case, nodes, monkeypatch):
    """With no plan, a node no kernel takes raises NotImplementedError on
    the card (a CPU tensor standing in for a card one, the H100's limits
    for the card's), as a wrapper refuses what it does not take; a plan
    that names it plain runs its plain version."""
    eng = Engine(_small(case).graph, _small(case).params, device="cpu")
    x = torch.randn(tuple(eng.graph.inputs["image"].shape),
                    generator=torch.Generator().manual_seed(1))
    _, env = execute(eng.graph, intermediates=True)(eng.params, image=x)
    monkeypatch.setattr(dispatch, "_on_card", lambda t: True)
    monkeypatch.setattr(dispatch.Limits, "of_card", staticmethod(lambda: H100))
    byname = eng.graph.node_map()
    for n in nodes:
        node = byname[n]
        args = [env[i] for i in node.inputs]
        with pytest.raises(NotImplementedError, match="no kernel takes"):
            run_node(node, eng.params, *args)
        assert torch.equal(run_node(node, eng.params, *args, kernel="plain"), env[n])
