"""The port's accuracy harness (``tf2_tpu_torch/eval/accuracy.py``) on the
CPU, against eval/accuracy.py: ``_average_precision`` equal to the
reference's on its unit cases and on seeded random boxes; ``golden_metrics``
within 1e-5 of the reference's formulas (``eval/accuracy.py:51-56``) on one
artifact (the reference's, ``transform.from_reference``) and the same
inputs, ``top1_agreement`` equal; ``detection_eval`` at W8, 128x128, 6
classes above the bar of tests/models/test_ssd.py; ``imagenet_eval`` on
generated shards and a checkpoint (the pattern of
tests/transform/test_checkpoint_drill.py); every entry point raising
without a card when the card is asked for. The reference runs on its jnp
path (Pallas off), never in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eval.accuracy import _average_precision as ref_average_precision
from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.kernels import dispatch as ref_dispatch
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import transform_model as ref_transform_model
from tf2_tpu_torch.eval import accuracy
from tf2_tpu_torch.graph import execute
from tf2_tpu_torch.graph.execute import no_tf32
from tf2_tpu_torch.graph.init_params import init_params
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.runtime import Engine
from tf2_tpu_torch.transform import from_reference

SMALL = dict(batch=4, image=32, classes=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _reference_off_pallas():
    prev = ref_dispatch._USE_PALLAS
    ref_dispatch.set_use_pallas(False)
    yield
    ref_dispatch.set_use_pallas(prev)


AP_UNITS = {
    "perfect": ([[0.1, 0.1, 0.4, 0.4]], [[0.1, 0.1, 0.4, 0.4, 0.9]]),
    "miss": ([[0.1, 0.1, 0.4, 0.4]], [[0.6, 0.6, 0.9, 0.9, 0.9]]),
    "duplicate": ([[0.1, 0.1, 0.4, 0.4]],
                  [[0.1, 0.1, 0.4, 0.4, 0.9], [0.1, 0.1, 0.4, 0.4, 0.8]]),
    "no_gt_no_det": (np.zeros((0, 4)), np.zeros((0, 5))),
    "no_gt_a_det": (np.zeros((0, 4)), [[0.1, 0.1, 0.4, 0.4, 0.9]]),
    "no_det": ([[0.1, 0.1, 0.4, 0.4]], np.zeros((0, 5))),
}


@pytest.mark.parametrize("case", sorted(AP_UNITS))
def test_average_precision_unit_cases(case):
    gt, det = (np.asarray(a, np.float64) for a in AP_UNITS[case])
    assert accuracy._average_precision(gt, det) == ref_average_precision(gt, det)
    want = {"perfect": 1.0, "miss": 0.0, "duplicate": 1.0}
    if case in want:
        assert accuracy._average_precision(gt, det) == want[case]


def _boxes(rng, n):
    xy = rng.uniform(0, 0.8, (n, 2))
    wh = rng.uniform(0.05, 0.4, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("iou", [0.5, 0.3])
def test_average_precision_on_random_boxes(seed, iou):
    """Ground truth and detections near it (jittered, some far away, some
    duplicated), sorted by score: the port's AP equals the reference's."""
    rng = np.random.default_rng(seed)
    gt = _boxes(rng, int(rng.integers(1, 8)))
    near = gt[rng.integers(0, len(gt), int(rng.integers(1, 12)))]
    near = near + rng.normal(0, 0.03, near.shape)
    det = np.concatenate([near, _boxes(rng, int(rng.integers(0, 5)))])
    det = np.concatenate([det, rng.uniform(0, 1, (len(det), 1))], axis=1)
    det = det[np.argsort(-det[:, 4])]
    got = accuracy._average_precision(gt, det, iou)
    assert got == ref_average_precision(gt, det, iou)
    assert 0.0 <= got <= 1.0


def _reference_metrics(yf, yq):
    """eval/accuracy.py:51-56, on one batch."""
    return {"rel_err": float(np.linalg.norm(yq - yf) / (np.linalg.norm(yf) + 1e-12)),
            "cosine": float((yf.ravel() @ yq.ravel())
                            / (np.linalg.norm(yf) * np.linalg.norm(yq) + 1e-12)),
            "top1_agreement": float((yf.argmax(-1) == yq.argmax(-1)).mean())}


def test_golden_metrics_match_the_reference_on_one_artifact():
    """The reference's artifact (its ``transform_model`` on the port's
    seeded calibration batches) through both packages: the port's Engine
    and folded FP32 forward give ``golden_metrics`` within 1e-5 of the
    reference's formulas on the reference's outputs, top-1 agreement equal."""
    g = ref_get_model("squeezenet_v1_1", **SMALL)
    params = {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()}
    calib, xs = accuracy.synthetic_batches(g.inputs["image"].shape, 2, 2, seed=0)
    art, fg, fp = ref_transform_model(
        g, params, [{"image": jnp.asarray(b["image"].numpy())} for b in calib],
        qspec=RefQuantSpec(weight_bits=4, bias_correct=False))
    ref_fp, ref_q = jax.jit(ref_execute(fg)), jax.jit(ref_execute(art.graph))
    pg, pp = from_reference(art.graph.to_json(), art.params)
    eng = Engine(pg, pp, device="cpu")
    pfg, pfp = from_reference(fg.to_json(), fp)
    fp_fn = execute(pfg)
    pfp = {k: torch.as_tensor(np.array(v)) for k, v in pfp.items()}
    for x in xs:
        with no_tf32():
            yf = fp_fn(pfp, image=x).numpy()
        got = accuracy.golden_metrics(yf, eng.run(image=x).numpy())
        want = _reference_metrics(np.asarray(ref_fp(fp, image=jnp.asarray(x.numpy()))),
                                  np.asarray(ref_q(art.params, image=jnp.asarray(x.numpy()))))
        assert abs(got["rel_err"] - want["rel_err"]) <= 1e-5, (got, want)
        assert abs(got["cosine"] - want["cosine"]) <= 1e-5, (got, want)
        assert got["top1_agreement"] == want["top1_agreement"]


def test_golden_metrics_on_detections_have_no_top1():
    y = np.random.default_rng(0).standard_normal((2, 100, 6)).astype(np.float32)
    m = accuracy.golden_metrics(y, y)
    assert m["top1_agreement"] is None and m["rel_err"] == 0.0
    assert abs(m["cosine"] - 1.0) < 1e-6


def test_golden_eval_on_cpu():
    r = accuracy.golden_eval("squeezenet_v1_1", 8, batches=2, batch=2, image=32, classes=10,
                             device="cpu")
    assert set(r) == {"mode", "model", "wbits", "rel_err_mean", "cosine_mean",
                      "top1_agreement"}
    assert r["mode"] == "golden" and r["cosine_mean"] > 0.95 and r["rel_err_mean"] < 0.3
    assert 0.0 <= r["top1_agreement"] <= 1.0


def test_detection_map_smoke():
    """Quantized SSD at W8 against the FP32 model's own detections: the bar
    of tests/models/test_ssd.py::test_detection_map_smoke."""
    r = accuracy.detection_eval(wbits=8, batches=1, batch=1, image=128, classes=6,
                                device="cpu")
    assert r["n_image_class_pairs"] > 0, "no detections above threshold"
    assert r["map50_vs_fp32"] > 0.6, r


def test_imagenet_eval_on_generated_shards(tmp_path):
    """A checkpoint of the graph's flat names and two labelled shards at
    64x64 -> a top-1 delta report (random weights and labels: no accuracy
    claim, a finite delta and the gate field)."""
    g = get_model("squeezenet_v1_1", batch=2, image=64)
    ckpt = tmp_path / "ckpt.npz"
    np.savez(ckpt, **init_params(g, seed=3))
    rng = np.random.default_rng(0)
    data = tmp_path / "data"
    data.mkdir()
    for s in range(2):
        np.savez(data / f"shard{s}.npz",
                 image=rng.normal(0, 1, (4, 64, 64, 3)).astype(np.float32),
                 label=rng.integers(0, 1000, (4,)))
    rep = accuracy.imagenet_eval("squeezenet_v1_1", 4, str(data), image=64, batch=2,
                                 checkpoint=str(ckpt), device="cpu")
    assert rep["mode"] == "imagenet"
    assert 0.0 <= rep["quant_top1"] <= 100.0 and 0.0 <= rep["fp32_top1"] <= 100.0
    assert rep["fp32_top1"] <= rep["fp32_top5"]
    assert np.isfinite(rep["top1_delta"]) and "pass" in rep
    assert rep["gate"] == accuracy.GATE_TOP1_DELTA
    with pytest.raises(FileNotFoundError):
        accuracy.imagenet_eval("squeezenet_v1_1", 4, str(tmp_path / "empty"), image=64,
                               batch=2, device="cpu")


def test_synthetic_batches_are_the_clis():
    """Calibration batches first, then the evaluation images, from the
    CLI's generator: one seed, the same images on every device."""
    from tf2_tpu_torch.transform.cli import calibration_batches

    calib, xs = accuracy.synthetic_batches((2, 8, 8, 3), 2, 3, seed=5)
    ref = calibration_batches((2, 8, 8, 3), 5, 5)
    assert len(calib) == 2 and len(xs) == 3
    for a, b in zip([c["image"] for c in calib] + xs, [r["image"] for r in ref]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("call", [
    lambda d: accuracy.golden_eval("squeezenet_v1_1", 8, batches=1, batch=1, image=32),
    lambda d: accuracy.detection_eval(batches=1, batch=1, image=128),
    lambda d: accuracy.imagenet_eval("squeezenet_v1_1", 8, d, image=64, batch=1),
    lambda d: accuracy.main(["--model", "squeezenet_v1_1", "--image", "32"]),
])
def test_entry_points_raise_without_a_card(call, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(str(tmp_path))
