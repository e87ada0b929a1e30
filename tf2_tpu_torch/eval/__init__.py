"""Accuracy harness of the port (``accuracy``): the quantized Engine held
against the folded FP32 forward, SSD's detections against the FP32
model's own, and top-1/top-5 on labelled shards."""
