"""The port's calibration (``tf2_tpu_torch/transform/calibrate.py``) against
tf2_tpu's on the CPU: SqueezeNet v1.1 and a depth-1 ResNet-50 (batch 2,
image 32), their BN-folded graphs and params equal in both packages, two
numpy-seeded batches.

- ``absmax`` and ``percentile``: the same keys, every scale within
  ``SCALE_RTOL`` (1e-5) relative of the reference's (measured at most
  8.71e-7). The forwards differ in the last bits (XLA's f32 against the
  port's float64 convolutions rounded to f32) and the percentile is
  ``jnp.percentile``'s linear interpolation, in its f32 steps, over the
  same NHWC strided subsample.
- ``mse``: the same keys; argmin can flip between near-equal candidates,
  so the port's clip is held by its total error in the reference's own
  computation: within ``SCALE_RTOL`` relative of the reference's least.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import execute as ref_execute
from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.transform import calibrate as ref_calibrate
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.transform import calibrate, fold_batch_norm
from tf2_tpu_torch.transform.calibrate import _MAX_SAMPLE, _subsample

SCALE_RTOL = 1e-5
MODELS = {"squeezenet_v1_1": dict(batch=2, image=32, classes=10),
          "resnet50": dict(batch=2, image=32, classes=10, depths=(1, 1, 1, 1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=list(MODELS))
def folded(request):
    name = request.param
    rg = ref_get_model(name, **MODELS[name])
    params = {k: np.asarray(v) for k, v in ref_init_params(rg, seed=0).items()}
    rfg, rfp = ref_fold(rg, params)
    fg, fp = fold_batch_norm(get_model(name, **MODELS[name]), params)
    assert fg.to_json() == rfg.to_json()
    rng = np.random.default_rng(7)
    batches = [{"image": rng.standard_normal(rg.inputs["image"].shape).astype(np.float32)}
               for _ in range(2)]
    return dict(name=name, fg=fg, fp=fp, rfg=rfg,
                rfp={k: np.asarray(v) for k, v in rfp.items()}, batches=batches)


@pytest.mark.parametrize("estimator", ["absmax", "percentile"])
def test_scales_match_reference(folded, estimator):
    got = calibrate(folded["fg"], folded["fp"], folded["batches"], estimator=estimator,
                    device="cpu")
    want = ref_calibrate(folded["rfg"], folded["rfp"],
                         [{"image": jnp.asarray(b["image"])} for b in folded["batches"]],
                         estimator=estimator)
    assert set(got) == set(want)
    assert "image" in got and all(s > 0 for s in got.values())
    worst = max(abs(got[k] - want[k]) / want[k] for k in want)
    assert worst <= SCALE_RTOL, worst


def _ref_mse_error(rfg, rfp, batches, name: str, clip: float) -> float:
    """The reference's pass-2 error of one clip for value ``name``
    (tf2_tpu/transform/calibrate.py, ``_mse_refine``'s ``fn``), summed
    over the batches."""
    run = jax.jit(ref_execute(rfg, intermediates=True))
    total = 0.0
    for b in batches:
        _, env = run(rfp, image=jnp.asarray(b["image"]))
        env = {"image": jnp.asarray(b["image"]), **env}
        x = env[name].astype(jnp.float32).ravel()
        s = jnp.float32(clip) / 127.0
        q = jnp.clip(jnp.round(x / s), -127, 127)
        total += float(jnp.mean(jnp.square(x - q * s)))
    return total


def test_mse_clips_are_least_error_in_the_reference(folded):
    """Each of the port's mse clips has, in the reference's error
    computation, a total error within SCALE_RTOL of that of the clip the
    reference chose (its least)."""
    got = calibrate(folded["fg"], folded["fp"], folded["batches"], estimator="mse",
                    device="cpu")
    rb = [{"image": jnp.asarray(b["image"])} for b in folded["batches"]]
    want = ref_calibrate(folded["rfg"], folded["rfp"], rb, estimator="mse")
    assert set(got) == set(want)
    differ = [k for k in want if abs(got[k] - want[k]) > SCALE_RTOL * want[k]]
    for k in differ:
        e_port = _ref_mse_error(folded["rfg"], folded["rfp"], folded["batches"], k, got[k] * 127)
        e_ref = _ref_mse_error(folded["rfg"], folded["rfp"], folded["batches"], k, want[k] * 127)
        assert e_port <= e_ref * (1 + SCALE_RTOL), (k, e_port, e_ref)
    print(f"{folded['name']}: {len(differ)} of {len(want)} mse clips differ by more than "
          f"{SCALE_RTOL} relative")


@pytest.mark.parametrize("n", [1000, _MAX_SAMPLE, _MAX_SAMPLE + 1, 3 * _MAX_SAMPLE + 5])
def test_subsample_is_the_references(n):
    """The strided subsample takes the reference's elements, in NHWC
    order."""
    from tf2_tpu.transform.calibrate import _subsample as ref_subsample
    v = np.random.default_rng(n).standard_normal((n,)).astype(np.float32).reshape(-1, 1, 1, 1)
    np.testing.assert_array_equal(_subsample(torch.as_tensor(v)).numpy(),
                                  np.asarray(ref_subsample(jnp.asarray(v))))


def test_unknown_estimator_and_no_batches_raise(folded):
    with pytest.raises(ValueError, match="unknown estimator"):
        calibrate(folded["fg"], folded["fp"], folded["batches"], estimator="max", device="cpu")
    with pytest.raises(ValueError, match="at least one batch"):
        calibrate(folded["fg"], folded["fp"], [], device="cpu")


def test_default_device_is_the_card(folded):
    """Numpy params and no ``device``: the card, which is missing here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(folded["fg"], folded["fp"], folded["batches"])
