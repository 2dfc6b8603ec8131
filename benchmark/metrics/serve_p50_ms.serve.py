"""The median request latency of the serving window, each request timed
from its send to when its host arrays came back: a steadier
statistic beside the tail."""


def read(run):
    return run.counters.get("serve_p50_ms")
