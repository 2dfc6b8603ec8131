"""Device kernels a training step: the kernel events of the traced steps
over their count."""


def read(run):
    t = run.trace
    return None if t is None else len(t.kernels) / t.units
