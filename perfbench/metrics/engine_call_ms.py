"""Host time from entering the Engine call to its return, the mean over the
window's calls outside the profiled slice (the harness's own clock around
the call)."""


def read(run):
    c = run.window.unprofiled()
    if not c:
        return None
    return sum(x.t1 - x.t0 for x in c) / len(c) * 1e-6
