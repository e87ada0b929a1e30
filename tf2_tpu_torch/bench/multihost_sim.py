"""Multi-process lockstep sim, the counterpart of the reference's
``bench/multihost_sim.py``: ``MultiHostEngine`` at one and at two local
ranks (``bench/mesh_worker.py``'s lockstep program; gloo on the CPU, where
each rank is pinned to its own cores) and the throughput of each data
plane and the two-against-one efficiency. On the CPU this measures the
protocol's overhead over loopback: a sanity check, not a scaling result.
With ``--device cuda`` both ranks share one card (gloo, collectives
through the host): not a scaling result either.

    python -m tf2_tpu_torch.bench.multihost_sim [--device cuda|cpu] [--out F]

Prints one JSON line and writes it to ``--out`` (default
``tf2_tpu_torch/bench/out/multihost_sim.json``, git-ignored; the reference's
``MULTIHOST_SIM.json`` at the repository root is not this bench's).
"""
from __future__ import annotations

import argparse
import json
import tempfile
from pathlib import Path

import numpy as np

from ..parallel.launch import spawn
from ..serve.multihost import scaling_efficiency

OUT_DIR = Path(__file__).with_name("out")   # the default --out's directory, git-ignored
GLOBAL_BATCH = 8
IMAGE = 32
STEPS = 4   # timed lockstep steps of each plane


def sim_artifact():
    """The sim's seeded artifact: ``synthetic_quantized`` ResNet-50, depths
    1-1-1-1, ``GLOBAL_BATCH`` x ``IMAGE`` x ``IMAGE``, 16 classes."""
    from ..models import synthetic_quantized

    return synthetic_quantized("resnet50", batch=GLOBAL_BATCH, image=IMAGE,
                               depths=(1, 1, 1, 1), classes=16)


def sim_inputs(shape) -> np.ndarray:
    return np.random.default_rng(7).standard_normal(shape).astype(np.float32)


def run_sim(nproc: int, device: str, out_dir, steps: int = STEPS,
            timeout_s: float = 600.0) -> dict:
    """The lockstep program on ``nproc`` local ranks over the sim's artifact
    and inputs, each plane timed over ``steps`` steps. ``out_dir`` receives
    the artifact, ``x.npz``, the config, each rank's ``rank{r}.json`` and
    rank 0's ``multihost.npz``; returns rank 0's report."""
    from ..transform import save_artifact

    out = Path(out_dir)
    art = sim_artifact()
    save_artifact(str(out / "art"), art.graph, art.params)
    np.savez(out / "x.npz", image=sim_inputs(art.graph.inputs["image"].shape))
    cfg = {"artifact": str(out / "art"), "inputs": str(out / "x.npz"), "out": str(out),
           "device": device, "pin_cores": True,
           "multihost": {"tp": 1, "throughput": steps}}
    (out / "cfg.json").write_text(json.dumps(cfg))
    spawn("tf2_tpu_torch.bench.mesh_worker:run", nproc,
          backend="gloo" if nproc > 1 else None, device=device,
          args=[str(out / "cfg.json")], timeout_s=timeout_s,
          env={"OMP_NUM_THREADS": "1"} if device == "cpu" else None)
    return json.loads((out / "rank0.json").read_text())


def measure(device: str = "cuda") -> dict:
    with tempfile.TemporaryDirectory() as d1, tempfile.TemporaryDirectory() as d2:
        r1, r2 = run_sim(1, device, d1), run_sim(2, device, d2)
    s1, s2 = r1["multihost"], r2["multihost"]
    where = ("cpu-loopback, each rank pinned to its own cores" if device == "cpu"
             else "2 processes sharing one card, gloo through the host")
    return {
        "sim": f"{where}, lockstep protocol, ResNet-50 depths 1-1-1-1 at {IMAGE}x{IMAGE}, "
               f"global batch {s1['global_batch']}",
        "device": r1["device"], "backend_2": r2["backend"],
        "img_s_1proc": s1["img_s"], "img_s_2proc": s2["img_s"],
        "scaling_efficiency_2proc_sim": scaling_efficiency(s1["img_s"], s2["img_s"], 2),
        "img_s_1proc_shard_local": s1["img_s_local"],
        "img_s_2proc_shard_local": s2["img_s_local"],
        "scaling_efficiency_2proc_shard_local_sim":
            scaling_efficiency(s1["img_s_local"], s2["img_s_local"], 2),
        "note": "protocol overhead sim only, not a scaling result: the ranks share one "
                "host (and, on the card, one GPU); shard_local = descriptor-only "
                "broadcast, per-rank feeds, no output gather",
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(OUT_DIR / "multihost_sim.json"),
                    help="also write the JSON line here (default: the git-ignored bench/out/)")
    args = ap.parse_args(argv)
    line = json.dumps(measure(args.device))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
