"""The depthwise convs' least time (the bound of the artifact's ``qconv2d``
nodes with ``groups > 1`` at the run's batch, ``counts.nodes``) over their
device time a call (``dwconv_ms``), in %."""
from .. import counts
from . import dwconv_ms


def read(run):
    ms = dwconv_ms.read(run)
    if ms is None or run.peak is None:
        return None
    grouped = {n["name"] for n in run.graph["nodes"]
               if n["op"] == "qconv2d" and n["attrs"].get("groups", 1) > 1}
    bound = sum(max(2 * n["macs"] / run.peak["int8_ops_per_s"],
                    n["bytes"] / run.peak["hbm_bytes_per_s"])
                for n in counts.nodes(run.graph, run.batch) if n["name"] in grouped)
    return bound / (ms * 1e-3) * 100.0
