"""Tools of the port (``python -m deepsense6g_tii_tpu_torch.tools.<name>``):
per-kernel timings and the roofline calibration on the card, the data
path's benchmarks (bench_io, bench_engine), the serving bench and the
train step's profile (bench_serve, profile_step, with the trace helpers in
trace.py), the matrix that runs them each in its own process
(bench_matrix), and the end-to-end accuracy checks without the dataset
(convergence_smoke, dba_regression).
"""
