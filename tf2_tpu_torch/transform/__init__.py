"""Transform Kit — the offline half: pruning, BN folding, calibration, PoT
weight fitting and quantization, bias correction, importers and artifact
IO; ``transform_model`` runs them in order and ``cli`` from the shell."""
from . import potq
from .calibrate import calibrate
from .export import from_reference, load_artifact, save_artifact, save_quantized
from .fold import fold_batch_norm
from .pipeline import transform_model
from .prune import PruneSpec, prune_params
from .quantize import QuantizedArtifact, QuantSpec, quantize_graph
