"""Percent of the traced training steps in which no kernel ran: 1 - the
union of kernel intervals over the traced window."""

from benchmark.core.trace import busy_us


def read(run):
    t = run.trace
    return None if t is None else 100.0 * (1 - busy_us(t.kernels) / t.window_us)
