"""Device time of the host-to-device copies a call, in the profiled slice."""


def read(run):
    s = run.window.slice
    if s is None or s.h2d_s <= 0:
        return None
    return s.h2d_s / s.calls * 1e3
