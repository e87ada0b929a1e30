"""tf2_tpu_torch — the shift-quantized inference engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The same artifact (``graph.json`` + ``weights.safetensors``) that the JAX
package ``tf2_tpu`` writes and reads runs here: the Transform Kit folds
batch norm and fits 4-bit power-of-two weight codes, and the runtime
``Engine`` executes the int8 graph with every conv and dense layer in one
of the kernels under ``kernels/csrc``. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; on the CPU every kernel wrapper takes
its plain PyTorch version.
"""
