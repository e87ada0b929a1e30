"""The artifact graph's operations (2 MACs an image: convs, dense layers,
attention products) times the images completed, over the wall time, over
the card's int8 peak, in %; over the window outside the profiled slice."""
from .. import counts


def read(run):
    w = run.window
    if run.peak is None or not w.calls:
        return None
    wall = run.window_s - w.slice_wall_s
    n = (len(w.calls) - w.slice_calls) * run.batch
    if wall <= 0 or n <= 0:
        return None
    return counts.ops_per_image(run.graph) * n / wall / run.peak["int8_ops_per_s"] * 100.0
