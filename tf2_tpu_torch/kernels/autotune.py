"""Measured kernel routing: the port's counterpart of
``tf2_tpu/kernels/autotune.py``, with its API and its key strings.

For every distinct conv and dense shape the sweep (``tune_graph``) times
each exact route of the node (``dispatch.ROUTES``: ``kernel``,
``kernel_int8``, ``library``) on the card and records the winner in a JSON
routing table. The Engine asks ``dispatch.route_conv`` / ``route_dense``
once at load, and they read the table here; with no entry a node takes
``kernel``, so an empty table changes nothing. (The attention core and the
LRN have one route each, their kernel, so no ``attn:`` or ``lrn:`` key is
asked; ``key_floor_s`` has no floor for them, as the reference's has none.) A route other than
``kernel`` is kept only when both timings are possible for the key
(``plausible``: not below the speed-of-light floor ``key_floor_s``) and it
beats ``kernel`` by the margin, outside the readings' spread; and
``validate_routes`` demotes a graph's routes when the routed Engine is not
faster end to end than the one on ``kernel`` everywhere.

The table lives at ``table_path()``: ``routing_<platform>.json``
(``platform()``: ``sm90`` on an H100, ``cpu`` without a card) in the
directory ``TF2TPU_TORCH_TUNE_DIR`` names, else in the git-ignored
``kernels/tuned/``. Where that table has no routes, the committed default
for the platform (``routing_defaults/``) is read: an empty default is a
correct one.

Times are device times from CUDA events: ``tune_graph`` replays a CUDA
graph of ``iters`` calls of one op, whose whole output is written;
``validate_routes`` times built (captured) Engines.
"""
from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path
from typing import Mapping

import numpy as np

TUNE_ENV = "TF2TPU_TORCH_TUNE_DIR"
_TUNE_DIR = Path(__file__).with_name("tuned")
_DEFAULTS_DIR = Path(__file__).with_name("routing_defaults")
_TABLE: dict | None = None          # {"routes": {...}, "detail": {...}}
_TABLE_PATH: str | None = None

# The H100 SXM's public peaks (data sheet), as ``chip_smoke.py`` takes
# them. The floor must stay a strict lower bound on any run: a higher
# assumed rate only lowers it.
_PEAK_INT8_OPS = 1979e12
_PEAK_HBM_BPS = 3.35e12


def platform() -> str:
    """``sm<major><minor>`` of the current card, ``cpu`` without one."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    major, minor = torch.cuda.get_device_capability()
    return f"sm{major}{minor}"


def default_path(plat: str | None = None) -> str:
    """The committed default table of ``plat`` (the current platform)."""
    return str(_DEFAULTS_DIR / f"routing_{plat or platform()}.json")


def table_path() -> str:
    if _TABLE_PATH is not None:
        return _TABLE_PATH
    d = os.environ.get(TUNE_ENV) or str(_TUNE_DIR)
    return os.path.join(d, f"routing_{platform()}.json")


def set_table_path(path: str | None) -> None:
    global _TABLE_PATH, _TABLE
    _TABLE_PATH = path
    _TABLE = None


def reset_table() -> None:
    """Start from an empty table (in memory) for a new sweep: neither the
    saved table nor the committed default is read until ``set_table_path``."""
    global _TABLE
    _TABLE = {"routes": {}, "detail": {}}


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, ValueError):
        return {"routes": {}, "detail": {}}
    return {"routes": dict(raw.get("routes", {})), "detail": dict(raw.get("detail", {}))}


def _load() -> dict:
    global _TABLE
    if _TABLE is None:
        t = _read_json(table_path())
        if not t["routes"] and os.path.exists(default_path()):
            t = _read_json(default_path())
        _TABLE = t
    return _TABLE


def _write(path: str, table: dict) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f, indent=0, sort_keys=True)
    os.replace(tmp, path)


def save() -> str:
    path = table_path()
    _write(path, _load())
    return path


def save_defaults() -> str:
    """Commit the current table as the repository's default for this
    platform."""
    path = default_path()
    _write(path, _load())
    return path


def conv_key(xshape, kshape, strides, groups, wfmt: str) -> str:
    n, h, w, _ = xshape
    kh, kw, cin, cout = kshape
    return (f"conv:b{n}:hw{h}x{w}:k{kh}x{kw}:ci{cin}:co{cout}:"
            f"s{strides[0]}{strides[1]}:g{groups}:{wfmt}")


def dense_key(xshape, kshape, wfmt: str) -> str:
    m = 1
    for d in xshape[:-1]:
        m *= d
    return f"dense:m{m}:k{kshape[0]}:n{kshape[1]}:{wfmt}"


def route(key: str) -> str | None:
    """The table's route for ``key`` (one of ``dispatch.ROUTES``), or None
    where nothing is recorded."""
    return _load()["routes"].get(key)


def detail(key: str) -> dict | None:
    return _load()["detail"].get(key)


def key_floor_s(key: str) -> float | None:
    """Speed-of-light lower bound of the op a conv or dense key describes:
    max(bytes / HBM rate, 2 * MACs / int8 peak), each input read and the
    output written once. None if the key is not one of those."""
    try:
        parts = key.split(":")
        kind = parts[0]
        f = {}
        for p in parts[1:]:
            for tag in ("hw", "ci", "co", "b", "k", "s", "g", "m", "n"):
                if p.startswith(tag) and p[len(tag):].replace("x", "").isdigit():
                    f[tag] = p[len(tag):]
                    break
        wbytes_per = 0.5 if parts[-1] == "pot4" else 1.0
        if kind == "conv":
            b = int(f["b"])
            h, w = (int(v) for v in f["hw"].split("x"))
            kh, kw = (int(v) for v in f["k"].split("x"))
            ci, co = int(f["ci"]), int(f["co"])
            sh, sw = int(f["s"][0]), int(f["s"][1])
            oh, ow = -(-h // sh), -(-w // sw)
            macs = b * oh * ow * co * kh * kw * ci
            byts = b * h * w * ci + kh * kw * ci * co * wbytes_per + b * oh * ow * co
        elif kind == "dense":
            m, k, n = int(f["m"]), int(f["k"]), int(f["n"])
            macs = m * k * n
            byts = m * k + k * n * wbytes_per + m * n
        else:
            return None
        return max(byts / _PEAK_HBM_BPS, 2 * macs / _PEAK_INT8_OPS)
    except (KeyError, ValueError, IndexError):
        return None


def plausible(key: str, t_ms: float | None) -> bool:
    """Is ``t_ms`` a physically possible time for this key?"""
    if t_ms is None or not (t_ms > 0) or t_ms == float("inf"):
        return False
    floor = key_floor_s(key)
    return floor is None or t_ms * 1e-3 >= floor


def record(key: str, winner: str, detail: dict | None = None) -> None:
    """Record a route, keeping one other than ``kernel`` only when both
    its time (``detail["<winner>_ms"]``) and ``kernel``'s
    (``detail["kernel_ms"]``) are plausible; otherwise ``kernel`` is
    recorded with the rejection in the detail."""
    t = _load()
    if winner != "kernel":
        d = detail or {}
        w_ok = plausible(key, d.get(f"{winner}_ms"))
        k_ok = plausible(key, d.get("kernel_ms"))
        if not (w_ok and k_ok):
            detail = dict(d, winner="kernel",
                          rejected=f"implausible timing ({winner}_ok={w_ok}, kernel_ok={k_ok}, "
                                   f"floor_ms={(key_floor_s(key) or 0) * 1e3:.6f})")
            winner = "kernel"
    t["routes"][key] = winner
    if detail is not None:
        t["detail"][key] = detail


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them, or its
    name alone where nvidia-smi is missing."""
    import torch

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(0)


# ---- the sweep ----

def graph_ms(fn, iters: int, reps: int = 1) -> list[float]:
    """Device ms a call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``reps`` times between CUDA events (after one eager
    call, which builds what the calls need)."""
    import torch

    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(iters):
            fn()
    g.replay()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def _node_runner(node, params: Mapping, route_: str, x, device):
    """A call of ``node`` on ``x`` by ``route_``, its weights prepared as
    the Engine prepares them for that route."""
    from types import SimpleNamespace

    import torch

    from ..graph.ir import Node
    from ..transform import potq
    from . import dispatch

    p = {k: torch.as_tensor(np.asarray(params[k])).to(device) for k in node.params}
    if route_ != "kernel" and node.attrs.get("wfmt") == "pot4":
        kshape = node.attrs["kshape"]
        kflat = int(np.prod(kshape[:-1]))
        codes = potq.unpack_codes_np(np.asarray(params[node.params[0]]), kflat)
        p[node.params[0]] = torch.as_tensor(potq.pot_decode_np(codes).reshape(kshape)).to(device)
        node = Node(node.name, node.op, node.inputs, node.params,
                    dict(node.attrs, wfmt="int8"))
    p = dispatch.prepare_weights(SimpleNamespace(nodes=[node]), p)
    if route_ == "library":
        fn = dispatch.qconv2d_library if node.op == "qconv2d" else dispatch.qdense_library
    else:
        fn = dispatch.qconv2d if node.op == "qconv2d" else dispatch.qdense
    return lambda: fn(node, p, x)


def tune_graph(graph, params: Mapping, persist: bool = True, iters: int = 20, reps: int = 5,
               verbose: bool = False, margin: float = 1.10, card: str | None = None) -> dict:
    """Time every exact route of each distinct conv and dense shape of
    ``graph`` (its ``qconv2d`` and ``qdense`` nodes as the artifact has
    them) on the card and record the winners. A route other than
    ``kernel`` wins when its median times ``margin`` is below ``kernel``'s
    and its slowest reading is below ``kernel``'s fastest; every route's
    output must equal ``kernel``'s bit for bit (else this raises). Returns
    {key: detail}; each detail names the card (``card``, else
    ``card_name()``)."""
    import torch

    from ..graph.shapes import activation_shapes
    from . import dispatch

    device = torch.device("cuda", torch.cuda.current_device())
    card = card or card_name()
    shapes = activation_shapes(graph, params)
    rng = np.random.default_rng(0)
    results: dict[str, dict] = {}
    for node in graph.nodes:
        if node.op not in ("qconv2d", "qdense") or node.attrs.get("wfmt") not in ("pot4", "int8"):
            continue
        xs = tuple(shapes[node.inputs[0]])
        a = node.attrs
        if node.op == "qconv2d":
            key = conv_key(xs, a["kshape"], a.get("strides", [1, 1]), a.get("groups", 1),
                           a["wfmt"])
            padding = a.get("padding", "SAME")
            choices = dispatch.conv_choices(
                a["kshape"], a.get("strides", [1, 1]),
                padding if isinstance(padding, str) else [tuple(p) for p in padding],
                a.get("groups", 1), a["wfmt"])
        else:
            if len(node.inputs) > 1:
                continue  # a folded residual: the Engine decodes its weight at load
            key = dense_key(xs, a["kshape"], a["wfmt"])
            choices = dispatch.dense_choices(a["wfmt"])
        if key in results or len(choices) == 1:
            continue
        x = torch.as_tensor(rng.integers(-80, 80, xs, dtype=np.int8)).to(device)
        runners = {r: _node_runner(node, params, r, x, device) for r in choices}
        want = runners["kernel"]()
        for r, fn in runners.items():
            if not torch.equal(fn(), want):
                raise RuntimeError(f"{key}: route {r} differs from kernel")
        times = {r: graph_ms(fn, iters, reps) for r, fn in runners.items()}
        med = {r: float(np.median(v)) for r, v in times.items()}
        floor = key_floor_s(key)
        best = min((r for r in choices if r != "kernel"), key=lambda r: med[r])
        wins = med[best] * margin < med["kernel"] and max(times[best]) < min(times["kernel"])
        winner = best if wins else "kernel"
        detail_ = {**{f"{r}_ms": med[r] for r in choices},
                   "readings_ms": times, "winner": winner, "margin": margin,
                   "floor_ms": (floor or 0.0) * 1e3, "card": card, "iters": iters}
        record(key, winner, detail_)
        results[key] = detail(key)
        if persist:
            save()
        if verbose:
            print(f"{key}: {json.dumps({k: v for k, v in detail(key).items() if k != 'readings_ms'})}",
                  flush=True)
    return results


def validate_routes(graph, params, batch_input=None, iters: int = 20, reps: int = 5,
                    tolerance: float = 0.01, verbose: bool = False) -> dict:
    """Whole-graph A/B of the table's routes against ``kernel`` everywhere
    (``dispatch.set_use_kernels(True)``): both Engines built (captured) and
    timed in turn, routed, kernel, kernel, routed; their outputs must be
    equal bit for bit. Unless the routed Engine is faster by ``tolerance``
    (medians) and outside the readings' spread (its slowest run faster than
    kernel's fastest), every route of this graph's keys other than
    ``kernel`` is demoted. A
    graph with no node off ``kernel`` is not timed. Returns {"routed_ms", "kernel_ms", "kept", "routed": its count of
    nodes off ``kernel``}."""
    import torch

    from ..graph.shapes import activation_shapes
    from ..runtime.engine import Engine
    from . import dispatch

    from ..runtime.engine import routes_of

    if not routes_of(graph, params):
        return {"routed_ms": None, "kernel_ms": None, "kept": False, "routed": 0}
    if batch_input is None:
        spec = next(iter(graph.inputs.values()))
        batch_input = np.random.default_rng(0).standard_normal(spec.shape).astype(np.float32)
    name = next(iter(graph.inputs))
    prev = dispatch.use_kernels()
    engines = {}
    try:
        for label, flag in (("routed", None), ("kernel", True)):
            dispatch.set_use_kernels(flag)
            engines[label] = Engine(graph, params).build(**{name: batch_input})
    finally:
        dispatch.set_use_kernels(prev)
    outs = {k: e.run(**{name: batch_input}) for k, e in engines.items()}
    if not torch.equal(outs["routed"], outs["kernel"]):
        raise RuntimeError(f"{graph.name}: the routed Engine's outputs differ from kernel's")
    times = {k: [] for k in engines}
    for label in ("routed", "kernel", "kernel", "routed"):
        r = engines[label].benchmark(iters=iters, reps=reps, **{name: batch_input})
        times[label].extend(r["per_rep_s"])
    ms = {k: float(np.median(v)) * 1e3 for k, v in times.items()}
    routed = engines["routed"].routes
    kept = (bool(routed) and ms["routed"] < ms["kernel"] * (1.0 - tolerance)
            and max(times["routed"]) < min(times["kernel"]))
    if routed and not kept:
        shapes = activation_shapes(graph, params)
        keys = set()
        for node in graph.nodes:
            if node.op == "qconv2d":
                a = node.attrs
                keys.add(conv_key(shapes[node.inputs[0]], a["kshape"], a.get("strides", [1, 1]),
                                  a.get("groups", 1), a.get("wfmt")))
            elif node.op == "qdense":
                keys.add(dense_key(shapes[node.inputs[0]], node.attrs["kshape"],
                                   node.attrs.get("wfmt")))
        t = _load()
        demoted = [k for k in keys if t["routes"].get(k, "kernel") != "kernel"]
        for k in demoted:
            t["routes"][k] = "kernel"
            t["detail"][k] = dict(t["detail"].get(k, {}), winner="kernel",
                                  rejected=f"whole-graph A/B: routed Engine {ms['routed']:.4f} ms "
                                           f"!< kernel {ms['kernel']:.4f} ms")
        if demoted:
            save()
        if verbose:
            print(f"validate_routes: demoted {len(demoted)} routes", flush=True)
    return {"routed_ms": ms["routed"], "kernel_ms": ms["kernel"], "kept": kept,
            "routed": len(routed), "readings_ms": {k: [t * 1e3 for t in v]
                                                   for k, v in times.items()}}
