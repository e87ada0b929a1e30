"""The port's offline half against tf2_tpu: PoT codes, IR JSON, artifact
files in both directions, model builder, BN folding and quantization.
Inputs come from numpy seeds and go through both packages; every check is
exact."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tf2_tpu.graph import init_params as ref_init_params
from tf2_tpu.models import get_model as ref_get_model
from tf2_tpu.transform import QuantSpec as RefQuantSpec
from tf2_tpu.transform import fold_batch_norm as ref_fold
from tf2_tpu.transform import load_artifact as ref_load_artifact
from tf2_tpu.transform import potq as ref_potq
from tf2_tpu.transform import quantize_graph as ref_quantize_graph
from tf2_tpu.transform import save_artifact as ref_save_artifact
from tf2_tpu_torch.graph import Graph, init_params
from tf2_tpu_torch.models import get_model
from tf2_tpu_torch.transform import (QuantSpec, fold_batch_norm, from_reference,
                                     load_artifact, potq, quantize_graph,
                                     save_artifact)
from tf2_tpu_torch.transform.export import _hash

SMALL = dict(batch=2, image=64, depths=(1, 1, 1, 1), classes=64)



def _ref_artifact(seed=0, wbits=4):
    g = ref_get_model("resnet50", **SMALL)
    fg, fp = ref_fold(g, {k: np.asarray(v) for k, v in ref_init_params(g, seed=seed).items()})
    scales = {k: 0.02 for k in fg.inputs}
    scales.update({n.name: 0.02 for n in fg.nodes})
    return g, fg, fp, scales, ref_quantize_graph(
        fg, fp, scales, RefQuantSpec(weight_bits=wbits, pot_candidates=5))


def test_pot_decode_all_codes():
    codes = np.arange(16, dtype=np.uint8)
    want = np.asarray(ref_potq.pot_decode(jnp.asarray(codes)))
    np.testing.assert_array_equal(potq.pot_decode(torch.as_tensor(codes)).numpy(), want)
    np.testing.assert_array_equal(potq.pot_decode_np(codes), want)
    np.testing.assert_array_equal(potq.pot_encode_from_int8(want),
                                  ref_potq.pot_encode_from_int8(want))


@pytest.mark.parametrize("k,n", [(1, 5), (7, 3), (64, 16), (147, 64), (576, 40)])
def test_pack_unpack_decode_random(k, n):
    codes = np.random.default_rng(k).integers(0, 16, (k, n)).astype(np.uint8)
    packed = potq.pack_codes(codes)
    np.testing.assert_array_equal(packed, ref_potq.pack_codes(codes))
    unpacked = potq.unpack_codes(torch.as_tensor(packed), k).numpy()
    np.testing.assert_array_equal(unpacked, codes)
    np.testing.assert_array_equal(
        unpacked, np.asarray(ref_potq.unpack_codes(jnp.asarray(packed), k)))
    np.testing.assert_array_equal(potq.unpack_codes_np(packed, k), codes)
    np.testing.assert_array_equal(
        potq.pot_decode(torch.as_tensor(unpacked)).numpy(),
        np.asarray(ref_potq.pot_decode(jnp.asarray(codes))))


@pytest.mark.parametrize("fit", ["fit_pot", "fit_int8"])
def test_weight_fitters_match(fit):
    w = np.random.default_rng(3).standard_normal((288, 48)).astype(np.float32) * 0.05
    q, s = getattr(potq, fit)(w, n_candidates=7)
    rq, rs = getattr(ref_potq, fit)(w, n_candidates=7)
    np.testing.assert_array_equal(q, rq)
    np.testing.assert_array_equal(s, rs)


@pytest.mark.parametrize("kw", [SMALL, dict(batch=1)])
def test_resnet_graph_json_matches(kw):
    assert get_model("resnet50", **kw).to_json() == ref_get_model("resnet50", **kw).to_json()


def test_ir_json_roundtrip_and_batch():
    _, _, _, _, art = _ref_artifact()
    text = art.graph.to_json()
    g = Graph.from_json(text)
    assert g.to_json() == text
    assert g.with_batch_size(5).to_json() == art.graph.with_batch_size(5).to_json()
    bad = json.loads(text)
    bad["ir_version"] = 99
    with pytest.raises(ValueError, match="IR version"):
        Graph.from_json(json.dumps(bad))


def test_port_reads_reference_artifact(tmp_path):
    _, _, _, _, art = _ref_artifact()
    ref_save_artifact(str(tmp_path), art.graph, art.params)
    g, params = load_artifact(str(tmp_path))
    assert g.to_json() == art.graph.to_json()
    assert set(params) == set(art.params)
    for k, v in art.params.items():
        assert params[k].dtype == v.dtype
        np.testing.assert_array_equal(params[k], v)


def test_reference_reads_port_artifact(tmp_path):
    from safetensors import safe_open

    _, _, _, _, art = _ref_artifact()
    g, params = from_reference(art.graph.to_json(), art.params)
    save_artifact(str(tmp_path), g, params)
    rg, rparams = ref_load_artifact(str(tmp_path))
    assert rg.to_json() == art.graph.to_json()
    for k, v in art.params.items():
        np.testing.assert_array_equal(rparams[k], v)
    with safe_open(str(tmp_path / "weights.safetensors"), framework="numpy") as f:
        hashes = json.loads(f.metadata()["hashes"])
    ref_dir = tmp_path / "ref"
    ref_save_artifact(str(ref_dir), art.graph, art.params)
    with safe_open(str(ref_dir / "weights.safetensors"), framework="numpy") as f:
        assert hashes == json.loads(f.metadata()["hashes"])


def test_artifact_hash_and_missing_param_checks(tmp_path):
    _, _, _, _, art = _ref_artifact()
    g, params = from_reference(art.graph.to_json(), art.params)
    save_artifact(str(tmp_path), g, params)
    wpath = tmp_path / "weights.safetensors"
    data = bytearray(wpath.read_bytes())
    data[-1] ^= 0xFF  # corrupt the last tensor byte
    wpath.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="hash mismatch"):
        load_artifact(str(tmp_path))
    del params["fc.es"]
    save_artifact(str(tmp_path), g, params)
    with pytest.raises(ValueError, match="missing params"):
        load_artifact(str(tmp_path))


@pytest.mark.parametrize("wbits", [4, 8])
def test_fold_and_quantize_match_reference(wbits):
    g, fg, fp, scales, art = _ref_artifact(wbits=wbits)
    pg = Graph.from_json(g.to_json())
    params = {k: np.asarray(v) for k, v in ref_init_params(g, seed=0).items()}
    pfg, pfp = fold_batch_norm(pg, params)
    assert pfg.to_json() == fg.to_json()
    for k, v in fp.items():
        np.testing.assert_array_equal(pfp[k], v)
    part = quantize_graph(pfg, pfp, scales, QuantSpec(weight_bits=wbits, pot_candidates=5))
    assert part.graph.to_json() == art.graph.to_json()
    assert {k: _hash(v) for k, v in part.params.items()} == \
        {k: _hash(np.asarray(v)) for k, v in art.params.items()}


def test_init_params_rules():
    g = get_model("resnet50", **SMALL)
    p = init_params(g, seed=0)
    assert set(p) == set(g.params)
    assert all(p[k].shape == tuple(s.shape) and p[k].dtype == np.float32
               for k, s in g.params.items())
    np.testing.assert_array_equal(p["conv1_bn.scale"], 1.0)
    np.testing.assert_array_equal(p["conv1_bn.offset"], 0.0)
    assert (p["conv1_bn.var"] >= 0.5).all() and (p["conv1_bn.var"] < 1.5).all()
    w = p["s4b0_c3.w"]
    assert abs(float(w.std()) - (2.0 / 512) ** 0.5) < 0.01
    np.testing.assert_array_equal(init_params(g, seed=0)["fc.w"], p["fc.w"])
    assert not np.array_equal(init_params(g, seed=1)["fc.w"], p["fc.w"])
