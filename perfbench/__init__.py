"""The benchmark of ``tf2_tpu_torch`` on an NVIDIA GPU: ``python -m perfbench.run``
(see ``README.md``)."""
