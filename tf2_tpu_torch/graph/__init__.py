from .ir import IR_VERSION, OPS, Graph, GraphBuilder, Node, TensorSpec
from .execute import execute, register_op
from .init_params import init_params
from . import detection_ops, qops  # register the detection and quantized-op executors
