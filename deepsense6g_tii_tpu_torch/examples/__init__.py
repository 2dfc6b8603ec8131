"""Examples of the port (``python -m deepsense6g_tii_tpu_torch.examples.
<name>``): ``quickstart``, the whole training path on a synthetic demo
tree."""
