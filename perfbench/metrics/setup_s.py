"""Process start to the first timed call: imports, CUDA, the kernel
libraries, the artifact, the Engine's load passes and weight preparation,
its build (an eager forward and the capture), the image pool, the warm-up
calls."""


def read(run):
    return run.setup_s
