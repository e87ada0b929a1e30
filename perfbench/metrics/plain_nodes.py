"""The nodes the Engine's coverage plan left to a plain version on the
card: the program's ``engine.plain_nodes`` counter, over the process (None
for a program without it)."""
from .. import spans


def read(run):
    return spans.counter("engine.plain_nodes")
