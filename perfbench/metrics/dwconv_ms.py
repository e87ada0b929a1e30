"""Device time a call of the depthwise conv kernel: the seconds of the
profiled slice's trace families whose name contains ``qdwconv``, over the
slice's calls, in ms. None where the slice has none (a program without the
kernel, or a configuration without depthwise convs)."""


def read(run):
    s = run.window.slice
    if s is None:
        return None
    t = [sec for family, sec in s.device_ops if "qdwconv" in family]
    return sum(t) / s.calls * 1e3 if t else None
