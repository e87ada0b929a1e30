"""The port's entry: its flagship forward with example arguments, the
counterpart of the reference's ``__graft_entry__.entry``.

``entry()`` returns ``(fwd, (params, image))``: ResNet-50 with W4-PoT
weights and int8 activations (``models.synthetic_quantized``, seed 0) at
batch 8, 224x224, loaded into an Engine on the card (``device="cpu"`` for
the plain path), and ``fwd(params, image)`` its forward.

``dryrun_multichip(n_ranks, backend=None, device="cuda")``, the
counterpart of the reference's: spawns ``n_ranks`` local ranks
(``parallel.launch``), each builds the (dp, tp) mesh (tp 2 where n is
even), an Engine of the quantized ResNet-50 (depths 1-1-1-1, image 64, 64
classes, global batch 2 * dp) on it, runs one forward of ones and checks
the gathered output's shape. The backend is the caller's (None: NCCL on
the card, gloo on the CPU; two ranks on one card take gloo, since NCCL
refuses two ranks of one communicator on one device); each rank prints
it.
"""
from __future__ import annotations

CONFIG = {"batch": 8, "image": 224}


def entry(device: str = "cuda", **overrides):
    """-> (fwd, (params, image)); ``overrides`` (batch, image, depths,
    classes) change the model's size."""
    import torch

    from .graph import execute
    from .models import synthetic_quantized
    from .runtime import Engine

    art = synthetic_quantized("resnet50", seed=0, **{**CONFIG, **overrides})
    eng = Engine(art.graph, art.params, device=device)
    fn = execute(eng.graph, kernels=eng.kernels)
    image = torch.zeros(art.graph.inputs["image"].shape, dtype=torch.float32,
                        device=eng.device)

    def fwd(params, image):
        return fn(params, image=image)

    return fwd, (eng.params, image)


def _quantized_resnet(batch: int, image: int, depths=(3, 4, 6, 3), classes: int = 1000):
    """The reference's ``__graft_entry__._quantized_resnet``: W4-PoT, the
    synthetic activation scales, no calibration forward."""
    from .models import synthetic_quantized

    return synthetic_quantized("resnet50", seed=0, batch=batch, image=image, depths=depths,
                               classes=classes)


def dryrun_multichip(n_ranks: int, backend: str | None = None, device: str = "cuda") -> None:
    from .parallel.launch import spawn

    logs = spawn("tf2_tpu_torch.entry:_dryrun_rank", n_ranks, backend=backend, device=device,
                 args=[device], timeout_s=600)
    print(logs[0].strip().splitlines()[-1])


def _dryrun_rank(device: str) -> None:
    import torch

    from .parallel import make_mesh
    from .runtime import Engine

    n = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    cfg = make_mesh(tp=2 if n % 2 == 0 else 1)
    batch = cfg.dp * 2
    art = _quantized_resnet(batch=batch, image=64, depths=(1, 1, 1, 1), classes=64)
    eng = Engine(art.graph, art.params, device=device, mesh=cfg)
    x = torch.ones(art.graph.inputs["image"].shape, dtype=torch.float32)
    out = eng.gather(eng.run(**eng.shard_inputs(image=x)))
    if tuple(out.shape) != (batch, 64):
        raise RuntimeError(f"dryrun_multichip: output {tuple(out.shape)}, expected {(batch, 64)}")
    backend = torch.distributed.get_backend() if torch.distributed.is_initialized() else None
    print(f"dryrun_multichip ok: mesh dp={cfg.dp} tp={cfg.tp} out={tuple(out.shape)} "
          f"backend={backend} device={eng.device}", flush=True)


if __name__ == "__main__":
    f, (p, x) = entry()
    print(tuple(f(p, x).shape), "entry ok")
