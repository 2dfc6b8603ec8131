"""Device kernels a request: the kernel events of the traced requests over
their count."""


def read(run):
    t = run.trace
    return None if t is None else len(t.kernels) / t.units
