"""Roofline analysis over the port's IR: per-layer MACs and bytes, the
card's ceilings, speed-of-light estimates, and the share achieved given a
measured time. The same count as the reference's ``bench/roofline.py``
(``conv_out_hw``, ``analyze``).

    python -m tf2_tpu_torch.bench.roofline --model resnet50 --batch 64 \
        [--measured-ms X] [--peaks FILE] [--per-layer]

Peaks: the NVIDIA H100 SXM data sheet (``DATASHEET``) unless ``--peaks``
names a file that ``bench/peaks.py`` wrote (``--out``), whose measured
int8, bf16 and 2-read-1-write HBM rates then take their place.
"""
from __future__ import annotations

import argparse
import json

# NVIDIA H100 SXM data sheet, dense rates (the figures chip_smoke.py takes)
DATASHEET = {"int8_ops_per_s": 1979e12, "bf16_flops_per_s": 989e12,
             "hbm_bytes_per_s": 3.35e12, "source": "NVIDIA H100 SXM data sheet"}


def measured_peaks(report: dict, source: str = "bench/peaks.py") -> dict:
    """Peaks from a ``bench/peaks.py`` report: int8 TOP/s, bf16 TFLOP/s and
    the 2-read-1-write HBM rate (the mix of a conv net's layer traffic)."""
    return {"int8_ops_per_s": report["int8_tops"] * 1e12,
            "bf16_flops_per_s": report["bf16_tflops"] * 1e12,
            "hbm_bytes_per_s": report["hbm_2r1w_gbps"] * 1e9,
            "source": f"measured ({source}: {report.get('card', '?')})"}


def load_peaks(path: str) -> dict:
    """``measured_peaks`` of the report a ``bench/peaks.py --out`` wrote."""
    with open(path) as f:
        return measured_peaks(json.load(f), path)


def conv_out_hw(h, w, kh, kw, sh, sw, padding):
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    return (h - kh) // sh + 1, (w - kw) // sw + 1


def analyze(graph, int8: bool = True, peaks: dict = DATASHEET) -> dict:
    """Walk the IR and sum MACs and tensor traffic per layer (convs, dense
    layers, f32 attention), as the reference does. Give it an artifact's
    graph (``load_artifact``, ``synthetic_quantized``), not an Engine's
    rewritten one: like the reference it counts no ``qblockchain`` or
    ``qattention_core`` node, so a block-fused graph's chains would count
    nothing."""
    shapes: dict[str, tuple] = {k: tuple(v.shape) for k, v in graph.inputs.items()}
    layers = []
    total_macs = 0
    total_bytes = 0
    act_bytes = 1 if int8 else 4
    for n in graph.nodes:
        t = None
        if n.op in ("conv2d", "qconv2d"):
            x = shapes[n.inputs[0]]
            if n.op == "qconv2d":
                kh, kw, cin_g, cout = n.attrs["kshape"]
            else:
                kh, kw, cin_g, cout = graph.params[n.params[0]].shape
            sh, sw = n.attrs.get("strides", [1, 1])
            oh, ow = conv_out_hw(x[1], x[2], kh, kw, sh, sw, n.attrs.get("padding", "SAME"))
            macs = x[0] * oh * ow * cout * kh * kw * cin_g
            w_bytes = kh * kw * cin_g * cout * (0.5 if n.attrs.get("wfmt") == "pot4" else 1)
            bytes_ = (x[0] * x[1] * x[2] * (cin_g * n.attrs.get("groups", 1)) * act_bytes
                      + w_bytes + x[0] * oh * ow * cout * act_bytes)
            t = (x[0], oh, ow, cout)
            layers.append({"name": n.name, "op": n.op, "macs": macs, "bytes": bytes_,
                           "intensity": macs / max(bytes_, 1)})
            total_macs += macs
            total_bytes += bytes_
        elif n.op in ("dense", "qdense"):
            x = shapes[n.inputs[0]]
            k, cout = (n.attrs["kshape"] if n.op == "qdense"
                       else graph.params[n.params[0]].shape)
            m = 1
            for d in x[:-1]:
                m *= d
            macs = m * k * cout
            bytes_ = m * k * act_bytes + k * cout + m * cout * act_bytes
            t = x[:-1] + (cout,)
            layers.append({"name": n.name, "op": n.op, "macs": macs, "bytes": bytes_,
                           "intensity": macs / max(bytes_, 1)})
            total_macs += macs
            total_bytes += bytes_
        elif n.op in ("maxpool", "avgpool"):
            x = shapes[n.inputs[0]]
            wh, ww = n.attrs["window"]
            sh, sw = n.attrs["strides"]
            oh, ow = conv_out_hw(x[1], x[2], wh, ww, sh, sw, n.attrs.get("padding", "VALID"))
            t = (x[0], oh, ow, x[3])
        elif n.op == "global_avgpool":
            x = shapes[n.inputs[0]]
            t = (x[0], x[3])
        elif n.op in ("concat", "qconcat"):
            xs = [shapes[i] for i in n.inputs]
            ax = n.attrs.get("axis", -1) % len(xs[0])
            t = list(xs[0])
            t[ax] = sum(s[ax] for s in xs)
            t = tuple(t)
        elif n.op == "reshape":
            t = tuple(n.attrs["shape"])
        elif n.op == "flatten":
            x = shapes[n.inputs[0]]
            m = 1
            for d in x[1:]:
                m *= d
            t = (x[0], m)
        elif n.op == "transpose":
            x = shapes[n.inputs[0]]
            t = tuple(x[p] for p in n.attrs["perm"])
        elif n.op == "attention":
            x = shapes[n.inputs[0]]
            b, tt, d = x
            macs = b * (4 * tt * d * d + 2 * tt * tt * d)
            layers.append({"name": n.name, "op": n.op, "macs": macs,
                           "bytes": 4 * d * d, "intensity": 0})
            total_macs += macs
            t = x
        else:
            t = shapes[n.inputs[0]] if n.inputs else None
        if t is not None:
            shapes[n.name] = t

    compute_s = 2 * total_macs / (peaks["int8_ops_per_s"] if int8 else peaks["bf16_flops_per_s"])
    memory_s = total_bytes / peaks["hbm_bytes_per_s"]
    return {
        "total_gmacs": total_macs / 1e9,
        "total_mbytes": total_bytes / 1e6,
        "sol_compute_ms": compute_s * 1e3,
        "sol_memory_ms": memory_s * 1e3,
        "sol_ms": max(compute_s, memory_s) * 1e3,
        "bound": "compute" if compute_s > memory_s else "memory",
        "peaks": peaks["source"],
        "layers": layers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image", type=int, default=224)
    ap.add_argument("--measured-ms", type=float, default=None)
    ap.add_argument("--peaks", default=None, help="a bench/peaks.py report (--out)")
    ap.add_argument("--per-layer", action="store_true")
    args = ap.parse_args(argv)
    from ..models import get_model

    g = get_model(args.model, batch=args.batch, image=args.image)
    r = analyze(g, peaks=load_peaks(args.peaks) if args.peaks else DATASHEET)
    out = {k: v for k, v in r.items() if k != "layers"}
    if args.measured_ms:
        out["measured_ms"] = args.measured_ms
        out["sol_fraction"] = r["sol_ms"] / args.measured_ms
    print(json.dumps(out, indent=1, default=float))
    if args.per_layer:
        for layer in sorted(r["layers"], key=lambda x: -x["macs"])[:20]:
            print(f"{layer['name']:24s} {layer['op']:8s} {layer['macs'] / 1e9:8.2f} GMAC "
                  f"intensity {layer['intensity']:8.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
