"""Device time a call of the int8 GELU kernel: the seconds of the profiled
slice's trace families whose name contains ``qgelu``, over the slice's
calls, in ms. None where the slice has none (a program without the kernel,
or a configuration without GELUs)."""


def read(run):
    s = run.window.slice
    if s is None:
        return None
    t = [sec for family, sec in s.device_ops if "qgelu" in family]
    return sum(t) / s.calls * 1e3 if t else None
