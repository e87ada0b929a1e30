"""Set-up seconds reading the artifact: the program's ``artifact.load``
span (``load_artifact``, its hashes included)."""
from .. import spans


def read(run):
    return spans.setup_s(run, lambda n: n == "artifact.load")
