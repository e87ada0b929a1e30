"""The 95th percentile over every request of the window, issue to logits on
the host."""
from . import latencies_ms, percentile


def read(run):
    return percentile(latencies_ms(run), 95)
