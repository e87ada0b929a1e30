"""The port's routing and trace tools on the CPU: ``context_sweep.graph_keys``
equal to the reference's ``graph_keys`` (bench/context_sweep.py:41-60,
computed here from ``tf2_tpu.graph.shapes`` and ``tf2_tpu.kernels.autotune``)
on ResNet-50 at batch 1 and 64; the keys a sweep takes from a block-fused
Engine; ``b1_context``'s fc route held in memory only; ``profile_trace``'s
join of device ops to nodes on small Chrome traces written here (an eager
forward, two replays, a replay that does not match); the SSD score cases'
biases; every bench's ``main`` raising without a card."""
import json

import numpy as np
import pytest
import torch

from tf2_tpu.graph.ir import Graph as RefGraph
from tf2_tpu.graph.shapes import activation_shapes as ref_activation_shapes
from tf2_tpu.kernels import autotune as ref_autotune
from tf2_tpu_torch.bench import b1_context, context_sweep, profile_trace, ssd_cases
from tf2_tpu_torch.kernels import autotune
from tf2_tpu_torch.models import synthetic_quantized
from tf2_tpu_torch.runtime import Engine

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def resnet50():
    """Full-width, full-depth ResNet-50's artifact graph (224x224, 1000
    classes)."""
    return synthetic_quantized("resnet50", seed=0, batch=1).graph


def _reference_graph_keys(graph):
    """bench/context_sweep.py:graph_keys on the reference's Graph."""
    shapes = ref_activation_shapes(graph)
    counts = {}
    for node in graph.nodes:
        if node.op == "qconv2d":
            key = ref_autotune.conv_key(shapes[node.inputs[0]], node.attrs["kshape"],
                                        node.attrs.get("strides", [1, 1]),
                                        node.attrs.get("groups", 1), node.attrs["wfmt"])
        elif node.op == "qdense":
            key = ref_autotune.dense_key(shapes[node.inputs[0]], node.attrs["kshape"],
                                         node.attrs["wfmt"])
        else:
            continue
        counts[key] = counts.get(key, 0) + 1
    return counts


@pytest.mark.parametrize("batch", [1, 64])
def test_graph_keys_equal_the_references(resnet50, batch):
    g = resnet50.with_batch_size(batch)
    got = context_sweep.graph_keys(g)
    assert got == _reference_graph_keys(RefGraph.from_json(g.to_json()))
    assert sum(got.values()) == 54   # 53 convs and the fc


def test_swept_keys_are_the_engines_nodes():
    """A block-fused Engine keeps the stem, the strided blocks' convs and
    the fc: only their keys with another route are swept, each counted
    once a node."""
    art = synthetic_quantized("resnet50", seed=0, **SMALL)
    keys = autotune.node_keys(art.graph, art.params)
    eng = Engine(art.graph, art.params, device="cpu")
    swept = context_sweep.swept_keys(keys, eng.graph.node_map())
    kept = [n for n in keys if n in eng.graph.node_map()]
    assert "conv1_relu" in kept and keys["conv1_relu"][1] == ("kernel",)   # the int8 stem
    assert not any(n.startswith("s1") for n in kept)            # stage 1 is a chain
    assert sum(c for c, _ in swept.values()) == len(kept) - 1
    assert swept[keys["fc"][0]] == (1, ("library",))
    assert set(swept) == {keys[n][0] for n in kept if len(keys[n][1]) > 1}


def test_sweep_error_is_half_the_base_spread():
    """The reference reads its error from the TPU relay's noise floor
    (``timing.noise_floor_s``, not ported); the port from the base's own
    repetitions: a route wins only by more than their whole spread."""
    assert context_sweep.error_s([0.70e-3, 0.74e-3, 0.72e-3]) == pytest.approx(0.02e-3)
    assert context_sweep.error_s([1.0, 1.0, 1.0]) == 0.0


def test_fc_route_lives_in_memory_only(tmp_path):
    """Variant C routes the fc to ``library`` in an in-memory table: its
    logits equal variant A's, and the table is as before afterwards (also
    after an exception inside)."""
    art = synthetic_quantized("resnet50", seed=0, **SMALL)
    routes = b1_context.fc_routes(art.graph, art.params)
    assert list(routes.values()) == ["library"] and list(routes)[0].startswith("dense:m2:")
    autotune.set_table_path(str(tmp_path / "t.json"))
    autotune.reset_table()
    try:
        c = b1_context.fc_routed(art.graph, art.params, device="cpu")
        assert c.routes == {"fc": "library"} and c.library_nodes == {"fc"}
        assert autotune.route(list(routes)[0]) is None
        with pytest.raises(KeyError):
            with autotune.routes_in_memory(routes):
                assert autotune.route(list(routes)[0]) == "library"
                raise KeyError("inside")
        assert autotune.route(list(routes)[0]) is None
        a = Engine(art.graph, art.params, device="cpu", block_fusion=False)
        x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
        assert torch.equal(a.run(image=x), c.run(image=x))
    finally:
        autotune.set_table_path(None)
    assert not (tmp_path / "t.json").exists()


def test_ssd_cases_take_the_biases():
    art = synthetic_quantized("ssd", seed=0, batch=1, image=128, classes=6)
    got = ssd_cases.case_params("background", art.graph, art.params, bg_bias=4.0, fg_bias=1.0)
    for node in art.graph.nodes:
        if node.op == "qconv2d" and node.name.startswith("conf"):
            s_out = float(node.attrs["out_scale"])
            want = np.array(art.params[node.params[2]], np.float32)
            want[0::6] += 4.0 / s_out
            for c in range(1, 6):
                want[c::6] -= 1.0 / s_out
            np.testing.assert_array_equal(got[node.params[2]], want)
    assert ssd_cases.case_params("random", art.graph, art.params).keys() == art.params.keys()


# ---- profile_trace's join, on Chrome traces written here ----

def _x(cat, name, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _kernel(name, ts, dur, corr):
    return _x("kernel", name, ts, dur, pid=0, tid=7, correlation=corr)


EAGER = [("qstem_kernel<qstem>", "conv1_relu"), ("elementwise_kernel<Fill>", "maxpool_0"),
         ("qblockchain_kernel<qblockchain>", "chain_0"), ("qmm_int8<qmatmul_int8>", "fc")]


def _eager_trace():
    """One forward in a "forward:0" range: four nodes, each launching one
    kernel (the stem with cudaLaunchKernelExC), the maxpool also a memset."""
    ev = [_x("user_annotation", "forward:0", 0, 1000)]
    corr = 10
    for i, (kernel, node) in enumerate(EAGER):
        op = {"conv1_relu": "qconv2d", "maxpool_0": "maxpool", "chain_0": "qblockchain",
              "fc": "qdense"}[node]
        t = 100 + 200 * i
        ev.append(_x("user_annotation", f"{op}:{node}", t, 150))
        ev.append(_x("cuda_runtime", "cudaLaunchKernelExC" if i == 0 else "cudaLaunchKernel",
                     t + 10, 5, correlation=corr))
        ev.append(_kernel(kernel, 5000 + 100 * i, 20 + 10 * i, corr))
        corr += 1
        if node == "maxpool_0":
            ev.append(_x("cuda_runtime", "cudaMemsetAsync", t + 20, 5, correlation=corr))
            ev.append(_x("gpu_memset", "Memset (Device)", 5050 + 100 * i, 3, pid=0, tid=7,
                         correlation=corr))
            corr += 1
    return ev


def _replay_trace(names):
    """Two replays, each in a "replay:<i>" range: a copy in, one graph
    launch (its kernels ``names`` and a memset, all with the launch's
    correlation id), a copy out."""
    ev, corr = [], 100
    for r in range(2):
        t0, d0 = 10_000 * (r + 1), 50_000 + 10_000 * r
        ev.append(_x("user_annotation", f"replay:{r}", t0, 900))
        ev.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 + 10, 5, correlation=corr))
        ev.append(_x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", d0, 2, pid=0, tid=7,
                     correlation=corr))
        ev.append(_x("cuda_runtime", "cudaGraphLaunch", t0 + 50, 100, correlation=corr + 1))
        for i, name in enumerate(names):
            ev.append(_kernel(name, d0 + 10 + 100 * i, 20 + 10 * i, corr + 1))
        ev.append(_x("gpu_memset", "Memset (Device)", d0 + 5, 1, pid=0, tid=7,
                     correlation=corr + 1))
        ev.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 + 300, 5, correlation=corr + 2))
        ev.append(_x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", d0 + 900, 1, pid=0,
                     tid=7, correlation=corr + 2))
        corr += 3
    return ev


def _written(tmp_path, name, events):
    """The events through a Chrome trace file, as torch.profiler writes it."""
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": events}))
    return profile_trace.load_events(str(path))


def test_eager_join_by_correlation(tmp_path):
    ops = profile_trace.device_ops(_written(tmp_path, "eager.json", _eager_trace()))
    forwards = profile_trace.eager_forwards(ops)
    assert len(forwards) == 1
    assert profile_trace.kernel_sequence(forwards[0]) == EAGER
    memset = [op for op in forwards[0] if op["cat"] == "gpu_memset"]
    assert [op["node"] for op in memset] == ["maxpool_0"]
    rep = profile_trace.attribution(forwards)
    assert rep["attributed_share"] == 1.0
    assert rep["per_node_ms"] == {"fc": 0.05, "chain_0": 0.04, "maxpool_0": 0.033,
                                  "conv1_relu": 0.02}


def test_eager_join_counts_what_no_node_launched(tmp_path):
    """A kernel launched outside any node's range (and one whose launch the
    trace lacks) is not attributed."""
    ev = _eager_trace() + [
        _x("cuda_runtime", "cudaLaunchKernel", 950, 5, correlation=90),
        _kernel("copy_kernel", 6000, 50, 90),
        _kernel("orphan", 6100, 50, 91)]
    forwards = profile_trace.eager_forwards(profile_trace.device_ops(ev))
    rep = profile_trace.attribution(forwards)
    assert rep["per_node_ms"]["<outside>"] == 0.05
    assert rep["attributed_share"] == pytest.approx(140 / 190)   # orphan: in no forward


def test_replay_join_by_order_and_name(tmp_path):
    sequence = list(EAGER)
    ops = profile_trace.device_ops(
        _written(tmp_path, "replay.json", _replay_trace([k for k, _ in EAGER])))
    forwards = profile_trace.replay_forwards(ops, sequence)
    assert len(forwards) == 2
    for fwd in forwards:
        assert [op["node"] for op in fwd] == ["<copy in>", "<memset (graph)>", "conv1_relu",
                                              "maxpool_0", "chain_0", "fc", "<copy out>"]
    rep = profile_trace.attribution(forwards)
    assert rep["attributed_share"] == 1.0
    assert list(rep["per_node_ms"])[:4] == ["fc", "chain_0", "maxpool_0", "conv1_relu"]
    assert rep["per_node_ms"]["<copy in>"] == 0.002
    assert rep["per_node_ms"]["<copy out>"] == 0.001
    assert rep["top_device_ops"][0]["node"] == "fc"


def test_replay_join_takes_a_copy_kernel_as_a_copy(tmp_path):
    """A copy node that CUDA runs as a kernel of its own (``memcpy128``:
    an eager forward's device-to-device memcpy, as SSD's sorts make) is an
    in-graph copy, outside the kernel sequence."""
    names = [k for k, _ in EAGER]
    ops = profile_trace.device_ops(
        _written(tmp_path, "replay.json", _replay_trace(names[:3] + ["memcpy128"] + names[3:])))
    forwards = profile_trace.replay_forwards(ops, list(EAGER))
    for fwd in forwards:
        assert [op["node"] for op in fwd] == ["<copy in>", "<memset (graph)>", "conv1_relu",
                                              "maxpool_0", "chain_0", "<memcpy (graph)>", "fc",
                                              "<copy out>"]


@pytest.mark.parametrize("names", [
    [k for k, _ in EAGER][:-1],                               # one kernel short
    [k for k, _ in EAGER] + ["extra"],                        # one more
    [EAGER[1][0], EAGER[0][0], EAGER[2][0], EAGER[3][0]],     # same count, order swapped
])
def test_replay_join_raises_on_a_mismatch(names):
    ops = profile_trace.device_ops(_replay_trace(names))
    with pytest.raises(ValueError, match="do not match the eager forward"):
        profile_trace.replay_forwards(ops, list(EAGER))


def test_replay_without_a_graph_launch_raises():
    ops = profile_trace.device_ops(_eager_trace())
    with pytest.raises(ValueError, match="no graph launch"):
        profile_trace.replay_forwards(ops, list(EAGER), label="forward")


@pytest.mark.parametrize("main", [b1_context.main, ssd_cases.main, profile_trace.main,
                                  context_sweep.main])
def test_bench_mains_raise_without_a_card(main):
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])
