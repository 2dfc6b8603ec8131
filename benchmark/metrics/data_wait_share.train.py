"""Share of the window the training loop waited for its next batch: the
program's own counter, ``Engine.epoch_stats[-1]["data_wait_share"]`` of the
window's epoch, in percent."""


def read(run):
    v = run.counters.get("data_wait_share")
    return None if v is None else 100.0 * v
