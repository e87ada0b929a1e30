from .ir import IR_VERSION, OPS, Graph, GraphBuilder, Node, TensorSpec
from .execute import execute, register_op
from .init_params import init_params
from . import qops  # registers the quantized-op executors
