"""Tools of the port (``python -m deepsense6g_tii_tpu_torch.tools.<name>``):
per-kernel timings and the roofline calibration on the card, the data
path's benchmarks (bench_io, bench_engine), and the end-to-end accuracy
checks without the dataset (convergence_smoke, dba_regression).
"""
