"""Scan kernels' share of their roofline in serving: the bound time of
every selective scan's forward at each traced request's bucket
(benchmark/reference/counts.py) over the device time of the kernels that
compute them, which the files of ``scan_roofline.serve.d/`` name."""

from benchmark.core.spec import name_list
from benchmark.core.trace import short_name
from benchmark.reference.counts import scan_bound_s


def read(run):
    t = run.trace
    if t is None:
        return None
    names = name_list("scan_roofline.serve")
    busy = sum(e - s for n, s, e in t.kernels if short_name(n) in names)
    if busy <= 0:
        return None
    bound = sum(scan_bound_s(run.config, b, False) for b in t.extra["buckets"])
    return 100.0 * bound / (busy / 1e6)
