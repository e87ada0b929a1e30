"""Transform Kit — the offline half: BN folding, PoT weight fitting and
quantization, and artifact IO."""
from . import potq
from .export import from_reference, load_artifact, save_artifact
from .fold import fold_batch_norm
from .quantize import QuantizedArtifact, QuantSpec, quantize_graph
