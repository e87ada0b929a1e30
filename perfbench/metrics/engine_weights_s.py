"""Set-up seconds putting the weights on the card as the kernels read them:
the program's ``engine.weights`` span (a child of ``engine.init``)."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n == "engine.weights")
