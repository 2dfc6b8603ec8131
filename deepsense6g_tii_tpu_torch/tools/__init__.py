"""Kernel tools of the port: per-kernel timings and the roofline
calibration on the card (``python -m deepsense6g_tii_tpu_torch.tools.<name>``).
"""
