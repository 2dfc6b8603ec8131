"""The serving window's forward FLOPs of the real (unpadded) rows, counted
from the reference's shapes, over the window's seconds, as a percent of
one card's bf16 dense peak."""

from benchmark.reference.counts import PEAK_BF16


def read(run):
    c = run.counters
    if "serve_flops" not in c:
        return None
    return 100.0 * c["serve_flops"] / c["window_s"] / PEAK_BF16
