"""The share of the window outside the profiled slice in which no kernel
runs, in %: one less the device busy time a call (``forward_ms``, from the
slice) times the calls there, over the wall time there. The profiler's
stalls inside the slice do not enter it; a copy counts as idle."""


def read(run):
    w, s = run.window, run.window.slice
    if s is None:
        return None
    wall = run.window_s - w.slice_wall_s
    n = len(w.calls) - w.slice_calls
    if wall <= 0 or n <= 0:
        return None
    return (1.0 - s.kernel_busy_s / s.calls * n / wall) * 100.0
