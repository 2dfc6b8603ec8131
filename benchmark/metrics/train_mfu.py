"""The training window's model FLOPs (3 forwards a sample, counted from the
reference's shapes, benchmark/reference/counts.py) over the window's
seconds, as a percent of one card's bf16 dense peak."""

from benchmark.reference.counts import PEAK_BF16


def read(run):
    c = run.counters
    if "train_flops" not in c:
        return None
    return 100.0 * c["train_flops"] / c["window_s"] / PEAK_BF16
