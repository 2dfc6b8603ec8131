"""Attention kernels' share of their roofline in training: the bound time
of every GPT block's attention forward and backward at the cell's shapes
(benchmark/reference/counts.py) over the device time of the kernels that
compute them, which the files of ``attn_roofline.train.d/`` name."""

from benchmark.core.spec import name_list
from benchmark.core.trace import short_name
from benchmark.reference.counts import attention_bound_s


def read(run):
    t = run.trace
    if t is None:
        return None
    names = name_list("attn_roofline.train")
    busy = sum(e - s for n, s, e in t.kernels if short_name(n) in names)
    if busy <= 0:
        return None
    bound = attention_bound_s(run.config, t.extra["batch"], True) * t.units
    return 100.0 * bound / (busy / 1e6)
