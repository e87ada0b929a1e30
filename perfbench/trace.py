"""What a profiled slice of the window shows: read from the Chrome trace
that ``torch.profiler`` writes. The slice runs from the start of the first
call the harness annotated (``pb:call``) to the end of the last
(``pb:to_host``, which waits for the logits on the host), so all of its
device work lies inside."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

# the port's CUDA kernels, by the name each carries (frozen copy of the
# wrapper names the port's runtime/profile.kernel_family matches)
PORT_KERNELS = ("qmatmul_pot4", "qmatmul_int8", "qconv_s1", "qconv_s2", "qconv_s2x1",
                "qblockchain", "qlrn", "qattention", "qstem", "nms")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("pb:call", "pb:to_host")


def kernel_family(name: str) -> str:
    """A port kernel by its wrapper's name; any other by its short name."""
    for k in PORT_KERNELS:
        if re.search(rf"\b{k}\b", name):
            return k
    short = re.split(r"[<(]", name.replace("(anonymous namespace)::", "").removeprefix("void "))[0]
    return "torch:" + short.split("::")[-1]


def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def covered(intervals) -> float:
    return sum(hi - lo for lo, hi in union(intervals))


@dataclass
class Slice:
    """Times in seconds."""
    window_s: float
    calls: int
    kernel_busy_s: float          # union of kernel intervals
    device_busy_s: float          # union of kernels, copies and sets
    h2d_s: float                  # host-to-device copies, summed
    device_ops: list = field(default_factory=list)    # [[family, s]], longest first
    idle_gaps: list = field(default_factory=list)     # [[span, s]], longest first


def read(events: list[dict]) -> Slice | None:
    """The slice of a trace's events, or None where it holds no annotated
    call or no device work."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("name") in SPANS
             and e.get("cat") == "user_annotation"]
    calls = [e for e in spans if e["name"] == "pb:call"]
    if not calls:
        return None
    t0 = min(e["ts"] for e in calls)
    t1 = max(e["ts"] + e["dur"] for e in spans)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1]
    kern = [(e["ts"], e["ts"] + e["dur"]) for e in dev if e["cat"] == "kernel"]
    if not kern:
        return None
    fam: dict[str, float] = {}
    for e in dev:
        key = kernel_family(e["name"]) if e["cat"] == "kernel" else e["name"]
        fam[key] = fam.get(key, 0.0) + e["dur"] * 1e-6
    merged = union(kern)
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps += [(t0, merged[0][0]), (merged[-1][1], t1)]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans)

    def doing(t: float) -> str:
        for lo, hi, name in host:
            if lo <= t <= hi:
                return name
        return "pb:loop"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return Slice(
        window_s=(t1 - t0) * 1e-6, calls=len(calls),
        kernel_busy_s=covered(kern) * 1e-6,
        device_busy_s=covered((e["ts"], e["ts"] + e["dur"]) for e in dev) * 1e-6,
        h2d_s=sum(e["dur"] for e in dev
                  if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]) * 1e-6,
        device_ops=[[k, v] for k, v in sorted(fam.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[doing((lo + hi) / 2), (hi - lo) * 1e-6] for lo, hi in longest if hi > lo])


def read_file(path) -> Slice | None:
    with open(path) as f:
        return read(json.load(f)["traceEvents"])
