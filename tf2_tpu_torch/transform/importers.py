"""Checkpoint importers: map source-framework state dicts onto the
engine's param names (the reference's, ``tf2_tpu/transform/importers.py``,
with its names and its faults: a square torch ``Linear`` loads
untransposed in ``import_torch_named``, as at the reference's
``importers.py:287``).

Supported sources:
- torchvision-style ResNet-50, SqueezeNet-1.1, GoogLeNet and ViT-B/16
  state dicts (OIHW conv layout, (out, in) linear layout; GoogLeNet's
  BatchNorms are folded into its conv weights at import, since the IR
  follows the original bias-only architecture);
- Keras-applications ResNet50 weight dicts (``conv1_conv/kernel`` naming,
  HWIO conv layout);
- torch-module naming of any conv/dense/batch_norm graph (SSD);
- flat numpy/safetensors dicts that already use the engine's names.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..graph.ir import Graph


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def conv_oihw_to_hwio(w: np.ndarray) -> np.ndarray:
    return _np(w).transpose(2, 3, 1, 0)


def import_torchvision_resnet50(state: Mapping, graph: Graph) -> dict:
    """torchvision resnet50 state_dict -> params for models/resnet.build().

    Name map: conv1->conv1, bn1->conv1_bn, layer{s}.{i}.conv{j} ->
    s{s}b{i}_c{j}, downsample.0/1 -> s{s}b{i}_down(+_bn), fc -> fc.
    """
    out: dict[str, np.ndarray] = {}

    def put_conv(src: str, dst: str):
        out[f"{dst}.w"] = conv_oihw_to_hwio(state[f"{src}.weight"])

    def put_bn(src: str, dst: str):
        out[f"{dst}.scale"] = _np(state[f"{src}.weight"])
        out[f"{dst}.offset"] = _np(state[f"{src}.bias"])
        out[f"{dst}.mean"] = _np(state[f"{src}.running_mean"])
        out[f"{dst}.var"] = _np(state[f"{src}.running_var"])

    put_conv("conv1", "conv1")
    put_bn("bn1", "conv1_bn")
    depths = (3, 4, 6, 3)
    for s, blocks in enumerate(depths):
        for i in range(blocks):
            src = f"layer{s + 1}.{i}"
            dst = f"s{s + 1}b{i}"
            for j in (1, 2, 3):
                put_conv(f"{src}.conv{j}", f"{dst}_c{j}")
                put_bn(f"{src}.bn{j}", f"{dst}_c{j}_bn")
            if f"{src}.downsample.0.weight" in state:
                put_conv(f"{src}.downsample.0", f"{dst}_down")
                put_bn(f"{src}.downsample.1", f"{dst}_down_bn")
    out["fc.w"] = _np(state["fc.weight"]).T
    out["fc.b"] = _np(state["fc.bias"])

    _check_against_graph(out, graph)
    return out


def import_torchvision_squeezenet1_1(state: Mapping, graph: Graph) -> dict:
    """torchvision squeezenet1_1 state_dict -> params for
    models/squeezenet.build().

    Name map: features.0 -> conv1; fire modules features.[3,4,6,7,9,10,
    11,12] -> fire2..fire9 (squeeze/expand1x1/expand3x3 ->
    _squeeze/_e1x1/_e3x3); classifier.1 -> conv10.
    """
    out: dict[str, np.ndarray] = {}

    def put(src: str, dst: str):
        out[f"{dst}.w"] = conv_oihw_to_hwio(state[f"{src}.weight"])
        out[f"{dst}.b"] = _np(state[f"{src}.bias"])

    put("features.0", "conv1")
    for fire_idx, feat_idx in zip(range(2, 10), (3, 4, 6, 7, 9, 10, 11, 12)):
        put(f"features.{feat_idx}.squeeze", f"fire{fire_idx}_squeeze")
        put(f"features.{feat_idx}.expand1x1", f"fire{fire_idx}_e1x1")
        put(f"features.{feat_idx}.expand3x3", f"fire{fire_idx}_e3x3")
    put("classifier.1", "conv10")

    _check_against_graph(out, graph)
    return out


def _fold_bn_into_conv(w_oihw, gamma, beta, mean, var,
                       eps: float = 1e-3) -> tuple[np.ndarray, np.ndarray]:
    """conv(+no bias) followed by BN == conv with scaled weights + bias:
    w'_o = w_o * g_o / sqrt(var_o + eps); b'_o = beta_o - g_o*mean_o/sqrt.
    Used when the source checkpoint is a BN variant of an architecture our
    IR models with plain biased convs (torchvision GoogLeNet)."""
    g = _np(gamma).astype(np.float64)
    s = g / np.sqrt(_np(var).astype(np.float64) + eps)
    w = _np(w_oihw).astype(np.float64) * s[:, None, None, None]
    b = _np(beta).astype(np.float64) - s * _np(mean).astype(np.float64)
    return w.astype(np.float32), b.astype(np.float32)


def _pad_kernel_center(w_oihw: np.ndarray, kh: int, kw: int) -> np.ndarray:
    """Zero-pad a smaller conv kernel to (kh, kw) centered — numerically
    identical under SAME padding (zero taps contribute nothing). Needed
    for torchvision GoogLeNet's branch3, which ships 3x3 kernels where the
    paper (and our IR) has 5x5."""
    o, i, h, w = w_oihw.shape
    if (h, w) == (kh, kw):
        return w_oihw
    ph, pw = (kh - h) // 2, (kw - w) // 2
    out = np.zeros((o, i, kh, kw), w_oihw.dtype)
    out[:, :, ph:ph + h, pw:pw + w] = w_oihw
    return out


def import_torchvision_googlenet(state: Mapping, graph: Graph) -> dict:
    """torchvision googlenet state_dict -> params for
    models/googlenet.build().

    torchvision's GoogLeNet is the BN variant (BasicConv2d = conv+BN, no
    bias); our IR follows the original biased-conv architecture, so every
    BN is folded into its conv here. Name map: conv1 -> conv1, conv2 ->
    conv2r, conv3 -> conv2, inception{blk}.branch1 -> inc{blk}_1x1,
    branch2.0/1 -> _3x3r/_3x3, branch3.0/1 -> _5x5r/_5x5 (3x3 kernels
    zero-padded to 5x5), branch4.1 -> _proj, fc -> fc.
    """
    out: dict[str, np.ndarray] = {}

    def put(src: str, dst: str, pad_to: tuple | None = None):
        w, b = _fold_bn_into_conv(
            state[f"{src}.conv.weight"], state[f"{src}.bn.weight"],
            state[f"{src}.bn.bias"], state[f"{src}.bn.running_mean"],
            state[f"{src}.bn.running_var"])
        if pad_to is not None:
            w = _pad_kernel_center(w, *pad_to)
        out[f"{dst}.w"] = w.transpose(2, 3, 1, 0)
        out[f"{dst}.b"] = b

    put("conv1", "conv1")
    put("conv2", "conv2r")
    put("conv3", "conv2")
    for blk in ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b"):
        src = f"inception{blk}"
        put(f"{src}.branch1", f"inc{blk}_1x1")
        put(f"{src}.branch2.0", f"inc{blk}_3x3r")
        put(f"{src}.branch2.1", f"inc{blk}_3x3")
        put(f"{src}.branch3.0", f"inc{blk}_5x5r")
        put(f"{src}.branch3.1", f"inc{blk}_5x5", pad_to=(5, 5))
        put(f"{src}.branch4.1", f"inc{blk}_proj")
    out["fc.w"] = _np(state["fc.weight"]).T
    out["fc.b"] = _np(state["fc.bias"])

    _check_against_graph(out, graph)
    return out


def import_keras_resnet50(weights: Mapping, graph: Graph) -> dict:
    """Keras-applications ResNet50 weights -> params for
    models/resnet.build() — the TF-side ingestion path.

    ``weights`` is a flat dict keyed ``"<layer>/<variable>"`` (the natural
    flattening of an .h5/SavedModel checkpoint): ``conv1_conv/kernel``,
    ``conv2_block1_1_bn/gamma`` ... Keras convs are already HWIO and
    denses (in, out) — no transposes. Keras ResNet50 convs carry biases
    while ours are bias-free + BN: the conv bias is folded into the BN
    running mean (BN(x + b): mean' = mean - b, exact).
    """
    out: dict[str, np.ndarray] = {}

    def put_pair(src: str, dst: str):
        out[f"{dst}.w"] = _np(weights[f"{src}_conv/kernel"])
        bias = weights.get(f"{src}_conv/bias")
        out[f"{dst}_bn.scale"] = _np(weights[f"{src}_bn/gamma"])
        out[f"{dst}_bn.offset"] = _np(weights[f"{src}_bn/beta"])
        mean = _np(weights[f"{src}_bn/moving_mean"])
        if bias is not None:
            mean = mean - _np(bias)
        out[f"{dst}_bn.mean"] = mean
        out[f"{dst}_bn.var"] = _np(weights[f"{src}_bn/moving_variance"])

    put_pair("conv1", "conv1")
    depths = (3, 4, 6, 3)
    for s, blocks in enumerate(depths):
        for i in range(blocks):
            src = f"conv{s + 2}_block{i + 1}"
            dst = f"s{s + 1}b{i}"
            for j in (1, 2, 3):
                put_pair(f"{src}_{j}", f"{dst}_c{j}")
            if f"{src}_0_conv/kernel" in weights:
                put_pair(f"{src}_0", f"{dst}_down")
    out["fc.w"] = _np(weights["predictions/kernel"])
    out["fc.b"] = _np(weights["predictions/bias"])

    _check_against_graph(out, graph)
    return out


def import_torchvision_vit_b16(state: Mapping, graph: Graph) -> dict:
    """torchvision ``vit_b_16`` state_dict -> params for models/vit.build().

    Name map: conv_proj -> patch_embed (OIHW->HWIO),
    encoder.pos_embedding -> pos_embed, encoder.layers.encoder_layer_{i}.
    {ln_1, self_attention.in_proj*, self_attention.out_proj, ln_2,
    mlp.linear_1|mlp.0, mlp.linear_2|mlp.3} -> blk{i}_{ln1, qkv, proj,
    ln2, mlp1, mlp2}, encoder.ln -> ln_final, heads.head -> head. The
    in_proj packing (q;k;v rows) and contiguous head split match this
    IR's qkv dense + attention_core exactly.

    Two graph variants (models/vit.py):
    - ``vit_b16`` (GAP head, the perf config): the class token is dropped
      and ``pos_embedding[:, 1:]`` used — loads structurally but real
      top-1 through the GAP head differs from torchvision's number.
    - ``vit_b16_cls`` (cls-token head): full NUMERIC parity — the class
      token, all 197 positions, and classification from token 0 match
      torchvision exactly; use this variant for the real-accuracy gate."""
    out: dict[str, np.ndarray] = {}
    out["patch_embed.w"] = conv_oihw_to_hwio(state["conv_proj.weight"])
    out["patch_embed.b"] = _np(state["conv_proj.bias"])
    pos = _np(state["encoder.pos_embedding"])
    t = graph.params["pos_embed"].shape[1]
    out["pos_embed"] = pos[:, -t:, :]  # GAP graph: drops the cls position
    if "cls_token" in graph.params:
        # vit_b16_cls: full numeric parity — cls token + all positions
        out["cls_token"] = _np(state["class_token"])

    def lin(src: str, dst: str):
        out[f"{dst}.w"] = _np(state[f"{src}.weight"]).T
        out[f"{dst}.b"] = _np(state[f"{src}.bias"])

    def ln(src: str, dst: str):
        out[f"{dst}.scale"] = _np(state[f"{src}.weight"])
        out[f"{dst}.offset"] = _np(state[f"{src}.bias"])

    i = 0
    while f"encoder.layers.encoder_layer_{i}.ln_1.weight" in state:
        src = f"encoder.layers.encoder_layer_{i}"
        ln(f"{src}.ln_1", f"blk{i}_ln1")
        out[f"blk{i}_qkv.w"] = _np(
            state[f"{src}.self_attention.in_proj_weight"]).T
        out[f"blk{i}_qkv.b"] = _np(
            state[f"{src}.self_attention.in_proj_bias"])
        lin(f"{src}.self_attention.out_proj", f"blk{i}_proj")
        ln(f"{src}.ln_2", f"blk{i}_ln2")
        mlp1 = (f"{src}.mlp.linear_1" if f"{src}.mlp.linear_1.weight"
                in state else f"{src}.mlp.0")
        mlp2 = (f"{src}.mlp.linear_2" if f"{src}.mlp.linear_2.weight"
                in state else f"{src}.mlp.3")
        lin(mlp1, f"blk{i}_mlp1")
        lin(mlp2, f"blk{i}_mlp2")
        i += 1
    ln("encoder.ln", "ln_final")
    lin("heads.head", "head")

    _check_against_graph(out, graph)
    return out


def import_torch_named(state: Mapping, graph: Graph,
                       extra: Mapping | None = None) -> dict:
    """Generic torch-module-naming importer: maps ``X.weight``/``X.bias``/
    ``X_bn.{weight,bias,running_mean,running_var}`` onto this IR's
    ``X.w``/``X.b``/``X_bn.{scale,offset,mean,var}`` with layout
    transposes by rank (OIHW->HWIO for convs, (out,in)->T for linears).
    Covers any graph built from conv/dense/batch_norm primitives — the
    SSD family's ingestion path (its backbone is this repo's own
    architecture, so a torch training run of it exports exactly these
    names). ``extra`` supplies generated params (e.g. SSD priors)."""
    out: dict[str, np.ndarray] = dict(extra or {})
    for pname, spec in graph.params.items():
        if pname in out:
            continue
        if pname.endswith(".w"):
            w = _np(state[pname[:-2] + ".weight"])
            if w.ndim == 4:
                w = w.transpose(2, 3, 1, 0)
            elif w.ndim == 2 and tuple(w.shape) != tuple(spec.shape):
                w = w.T
            out[pname] = w
        elif pname.endswith(".b"):
            out[pname] = _np(state[pname[:-2] + ".bias"])
        elif pname.endswith("_bn.scale"):
            out[pname] = _np(state[pname[:-9] + "_bn.weight"])
        elif pname.endswith("_bn.offset"):
            out[pname] = _np(state[pname[:-10] + "_bn.bias"])
        elif pname.endswith("_bn.mean"):
            out[pname] = _np(state[pname[:-8] + "_bn.running_mean"])
        elif pname.endswith("_bn.var"):
            out[pname] = _np(state[pname[:-7] + "_bn.running_var"])
        elif pname in state:
            out[pname] = _np(state[pname])
        else:
            raise ValueError(f"no source key for graph param {pname!r}")
    _check_against_graph(out, graph)
    return out


def import_torch_ssd(state: Mapping, graph: Graph) -> dict:
    """torch checkpoint -> params for models/ssd.build(): the generic
    torch-naming map plus generated priors (not a learned tensor)."""
    from ..models.ssd import init_priors
    return import_torch_named(state, graph, extra=init_priors(graph))


def import_flat(state: Mapping, graph: Graph) -> dict:
    """Flat dict already keyed by our names (e.g. re-exported safetensors)."""
    out = {k: _np(v) for k, v in state.items() if k in graph.params}
    _check_against_graph(out, graph)
    return out


_TV_IMPORTERS = {
    "resnet50": import_torchvision_resnet50,
    "squeezenet_v1_1": import_torchvision_squeezenet1_1,
    "googlenet": import_torchvision_googlenet,
    "vit_b16": import_torchvision_vit_b16,
    "ssd_resnetish": import_torch_ssd,
    "ssd": import_torch_ssd,
}


def load_checkpoint(path: str, graph: Graph) -> dict:
    """Load ANY supported checkpoint file and map it onto ``graph``'s
    params — the single entry point the CLI uses.

    File formats: ``.safetensors`` (``export.read_safetensors``), torch ``.pth``/``.pt``/
    ``.bin`` (``torch.load(weights_only=True)``, CPU; a nested ``state_dict`` key is unwrapped),
    ``.npz``, ``.caffemodel`` (transform/caffe.py wire parser).
    Naming: our flat names are used directly; otherwise the importer for
    the graph's model family is applied (torchvision/Keras detection by
    key shape)."""
    import os

    if path.endswith(".caffemodel"):
        from .caffe import (googlenet_name_map, import_caffe,
                            parse_caffemodel, squeezenet_v1_1_name_map)
        with open(path, "rb") as f:
            layers = parse_caffemodel(f.read())
        nmap = (googlenet_name_map() if graph.name.startswith("googlenet")
                else squeezenet_v1_1_name_map())
        return import_caffe(layers, graph, nmap)
    if path.endswith(".safetensors"):
        from .export import read_safetensors
        state: Mapping = read_safetensors(path)[0]
    elif path.endswith(".npz"):
        state = dict(np.load(path))
    else:  # torch pickle formats
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(raw, Mapping) and "state_dict" in raw:
            raw = raw["state_dict"]
        state = raw

    keys = set(state.keys())
    if set(graph.params) <= keys:
        return import_flat(state, graph)
    if any("/" in k for k in keys):  # keras naming (conv1_conv/kernel)
        # the only Keras importer is the ResNet-50 one — a Keras-named
        # checkpoint for another family must fall through to the clean
        # "cannot infer importer" error, not a KeyError
        if graph.name.startswith("resnet50"):
            return import_keras_resnet50(state, graph)
    name = graph.name.split("_pruned")[0]
    for family, fn in _TV_IMPORTERS.items():
        if name.startswith(family) or name == family:
            return fn(state, graph)
    raise ValueError(
        f"cannot infer importer for checkpoint {os.path.basename(path)} "
        f"(graph {graph.name!r}); keys like {sorted(keys)[:4]}")


def _check_against_graph(params: dict, graph: Graph) -> None:
    missing = sorted(set(graph.params) - set(params))
    if missing:
        raise ValueError(f"importer missing params: {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}")
    for k, spec in graph.params.items():
        got = tuple(params[k].shape)
        if got != tuple(spec.shape):
            raise ValueError(f"shape mismatch for {k}: checkpoint {got} "
                             f"vs graph {tuple(spec.shape)}")
