"""The port's entry: its flagship forward with example arguments, the
counterpart of the reference's ``__graft_entry__.entry``.

``entry()`` returns ``(fwd, (params, image))``: ResNet-50 with W4-PoT
weights and int8 activations (``models.synthetic_quantized``, seed 0) at
batch 8, 224x224, loaded into an Engine on the card (``device="cpu"`` for
the plain path), and ``fwd(params, image)`` its forward. The reference's
``dryrun_multichip`` waits for the port's parallelism (ROADMAP Queue 1).
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
    fn = execute(eng.graph, plain_nodes=eng.plain_nodes, library_nodes=eng.library_nodes)
    image = torch.zeros(art.graph.inputs["image"].shape, dtype=torch.float32,
                        device=eng.device)

    def fwd(params, image):
        return fn(params, image=image)

    return fwd, (eng.params, image)


if __name__ == "__main__":
    f, (p, x) = entry()
    print(tuple(f(p, x).shape), "entry ok")
