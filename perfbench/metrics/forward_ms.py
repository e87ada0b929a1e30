"""Device busy time a call: the union of kernel intervals in the profiled
slice over its calls."""


def read(run):
    s = run.window.slice
    if s is None:
        return None
    return s.kernel_busy_s / s.calls * 1e3
