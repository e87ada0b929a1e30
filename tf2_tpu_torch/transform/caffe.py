"""Caffe checkpoint ingestion without a caffe or protobuf dependency (the
reference's, ``tf2_tpu/transform/caffe.py``).

``.caffemodel`` files are protobuf wire format, and the few fields needed
(layer names, types, weight blobs) decode with a short reader:

    NetParameter:   field 100 = repeated LayerParameter   (new-style)
                    field 2   = repeated V1LayerParameter (legacy)
    LayerParameter: 1 = name, 2 = type(str) / 5 = type(enum, legacy),
                    7 = blobs (legacy V1: 6 = blobs)
    BlobProto:      7 = shape{1: packed int64 dims}, 5 = packed float data,
                    6 = double data, legacy 1..4 = num/channels/height/width

Caffe conv blobs are OIHW (like torch); FC blobs are (out, in).
``import_caffe`` maps parsed layers onto graph params by a name map, with
the torchvision importers' transposes.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, Mapping

import numpy as np


# ---- protobuf wire-format primitives ----------------------------------------

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: memoryview) -> Iterable[tuple[int, int, memoryview | int]]:
    """Yield (field_number, wire_type, payload) over a message buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                    # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, val
        elif wt == 1:                  # 64-bit
            yield field, wt, buf[pos:pos + 8]
            pos += 8
        elif wt == 2:                  # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:                  # 32-bit
            yield field, wt, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} at {pos}")


def _packed_floats(payload: memoryview) -> np.ndarray:
    return np.frombuffer(payload, dtype="<f4").copy()


def _packed_varints(payload: memoryview) -> list[int]:
    out = []
    pos = 0
    while pos < len(payload):
        v, pos = _read_varint(payload, pos)
        out.append(v)
    return out


# ---- caffe messages ----------------------------------------------------------

def _parse_blob(buf: memoryview) -> np.ndarray:
    shape: list[int] = []
    legacy = {}
    data = None
    for field, wt, payload in _fields(buf):
        if field == 7 and wt == 2:        # BlobShape
            for f2, w2, p2 in _fields(payload):
                if f2 == 1:
                    if w2 == 2:
                        shape.extend(_packed_varints(p2))
                    else:
                        shape.append(p2)
        elif field == 5 and wt == 2:      # packed float data
            data = _packed_floats(payload)
        elif field == 5 and wt == 5:      # unpacked float (rare)
            v = struct.unpack("<f", payload)[0]
            data = np.append(data if data is not None else
                             np.empty(0, np.float32), v)
        elif field == 6 and wt == 2:      # double data
            data = np.frombuffer(payload, dtype="<f8").astype(np.float32)
        elif field in (1, 2, 3, 4) and wt == 0:   # legacy dims
            legacy[field] = payload
    if data is None:
        data = np.empty(0, np.float32)
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
    if shape and int(np.prod(shape)) == data.size:
        data = data.reshape(shape)
    return data


_V1_TYPE_NAMES = {4: "Convolution", 14: "InnerProduct", 18: "ReLU",
                  17: "Pooling", 15: "LRN", 3: "Concat", 20: "Softmax",
                  5: "Data", 6: "Dropout", 8: "Eltwise"}


def _parse_layer(buf: memoryview, legacy: bool) -> dict:
    name = ""
    ltype = ""
    blobs: list[np.ndarray] = []
    blob_field = 6 if legacy else 7
    for field, wt, payload in _fields(buf):
        if field == 1 and wt == 2:
            name = bytes(payload).decode("utf-8", "replace")
        elif field == 2 and wt == 2 and not legacy:
            ltype = bytes(payload).decode("utf-8", "replace")
        elif field == 5 and wt == 0 and legacy:
            ltype = _V1_TYPE_NAMES.get(payload, str(payload))
        elif field == blob_field and wt == 2:
            blobs.append(_parse_blob(payload))
    return {"name": name, "type": ltype, "blobs": blobs}


def parse_caffemodel(data: bytes | BinaryIO) -> dict[str, dict]:
    """.caffemodel bytes -> {layer_name: {"type", "blobs": [np arrays]}}.

    Handles both new-style (field 100) and legacy V1 (field 2) layers;
    layers without blobs (ReLU, Pooling, ...) are skipped.
    """
    if hasattr(data, "read"):
        data = data.read()
    buf = memoryview(data)
    layers: dict[str, dict] = {}
    for field, wt, payload in _fields(buf):
        if wt != 2:
            continue
        if field == 100:
            layer = _parse_layer(payload, legacy=False)
        elif field == 2:
            layer = _parse_layer(payload, legacy=True)
        else:
            continue
        if layer["blobs"]:
            layers[layer["name"]] = {"type": layer["type"],
                                     "blobs": layer["blobs"]}
    return layers


# ---- serialization (for tests / re-export) -----------------------------------

def _varint(v: int) -> bytes:
    out = b""
    while True:
        b7 = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b7 | 0x80])
        else:
            return out + bytes([b7])


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def write_caffemodel(layers: Mapping[str, dict]) -> bytes:
    """Inverse of parse_caffemodel (new-style schema) — used by the tests
    to synthesize structurally-exact .caffemodel files, and available for
    re-exporting weights toward Caffe tooling."""
    out = b""
    for name, spec in layers.items():
        msg = _ld(1, name.encode())
        msg += _ld(2, spec.get("type", "").encode())
        for blob in spec.get("blobs", ()):
            arr = np.ascontiguousarray(blob, np.float32)
            shape_msg = b""
            for d in arr.shape:
                shape_msg += _varint(1 << 3 | 0) + _varint(d)
            bmsg = _ld(7, shape_msg)
            bmsg += _ld(5, arr.tobytes())
            msg += _ld(7, bmsg)
        out += _ld(100, msg)
    return out


# ---- graph import ------------------------------------------------------------

def import_caffe(layers: Mapping[str, dict], graph, name_map: Mapping[str, str],
                 fc_names: Iterable[str] = ()) -> dict:
    """Map parsed caffemodel layers onto graph params.

    name_map: caffe layer name -> our conv/dense base name ("conv1" maps
    blobs to conv1.w/conv1.b). Conv blobs OIHW -> HWIO; layers listed in
    ``fc_names`` are InnerProduct (out,in) -> (in,out).
    """
    from .importers import _check_against_graph, conv_oihw_to_hwio

    fc = set(fc_names)
    out: dict[str, np.ndarray] = {}
    for src, dst in name_map.items():
        if src not in layers:
            raise ValueError(f"caffemodel missing layer {src!r}")
        blobs = layers[src]["blobs"]
        w = blobs[0]
        if src in fc or dst in fc:
            out[f"{dst}.w"] = np.asarray(w, np.float32).T
        else:
            out[f"{dst}.w"] = conv_oihw_to_hwio(np.asarray(w, np.float32))
        if len(blobs) > 1:
            out[f"{dst}.b"] = np.asarray(blobs[1], np.float32)
    _check_against_graph(out, graph)
    return out


def squeezenet_v1_1_name_map() -> dict[str, str]:
    """Official SqueezeNet v1.1 caffemodel layer names -> our params."""
    m = {"conv1": "conv1", "conv10": "conv10"}
    for i in range(2, 10):
        m[f"fire{i}/squeeze1x1"] = f"fire{i}_squeeze"
        m[f"fire{i}/expand1x1"] = f"fire{i}_e1x1"
        m[f"fire{i}/expand3x3"] = f"fire{i}_e3x3"
    return m


def googlenet_name_map() -> dict[str, str]:
    """BVLC GoogLeNet caffemodel layer names -> our params."""
    m = {"conv1/7x7_s2": "conv1", "conv2/3x3_reduce": "conv2r",
         "conv2/3x3": "conv2", "loss3/classifier": "fc"}
    for blk in ("3a", "3b", "4a", "4b", "4c", "4d", "4e", "5a", "5b"):
        m[f"inception_{blk}/1x1"] = f"inc{blk}_1x1"
        m[f"inception_{blk}/3x3_reduce"] = f"inc{blk}_3x3r"
        m[f"inception_{blk}/3x3"] = f"inc{blk}_3x3"
        m[f"inception_{blk}/5x5_reduce"] = f"inc{blk}_5x5r"
        m[f"inception_{blk}/5x5"] = f"inc{blk}_5x5"
        m[f"inception_{blk}/pool_proj"] = f"inc{blk}_proj"
    return m
