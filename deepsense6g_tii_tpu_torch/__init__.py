"""deepsense6g_tii_tpu_torch: the PyTorch/CUDA port of deepsense6g_tii_tpu
for NVIDIA Hopper (sm_90a).

Module paths mirror the JAX package, so each part's counterpart is found by
name.  The port imports torch and numpy only, never jax, flax or the JAX
package.  Layers:

  config.py   GlobalConfig (own copy)
  data/       ImageNet normalisation
  ops/        pooling, bilinear resize, flash attention (hand-written CUDA
              kernel in csrc/, built with nvcc at first use)
  models/     ResNet backbones, GPT token fusion, encoder, BeamFuser, and
              the weight bridge from JAX variables
  serve.py    Predictor: batch buckets, top-k beams, latency benchmark

Entry points run on the GPU (``device="cuda"``) and raise when CUDA is
absent unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import GlobalConfig  # noqa: F401
