"""deepsense6g_tii_tpu_torch: the PyTorch/CUDA port of deepsense6g_tii_tpu
for NVIDIA Hopper (sm_90a).

Module paths mirror the JAX package, so each part's counterpart is found by
name.  The port imports torch and numpy only, never jax, flax or the JAX
package.  Layers:

  config.py   GlobalConfig (own copy)
  data/       features, the DeepSense dataset and loader, the memmap
              cache
  runtime/    the native C++ PLY/BEV/k-d tree loader (g++ at first use)
  ops/        pooling, bilinear resize, flash attention and the selective
              scan (hand-written CUDA kernels in csrc/, built with nvcc at
              first use)
  models/     ResNet backbones, GPT and Mamba token fusion, encoder (with
              the modality-rebuild hook), BeamFuser, and the weight bridges
              from JAX variables, flax msgpack and reference .pth files
  train/      train and eval steps, engine, checkpoints
  rebuild/    the modality-rebuild heads, losses and trainer, and the
              video/flow/audio trainer
  cli/        the train and rebuild CLIs
  serve.py    Predictor: batch buckets, top-k beams, latency benchmark
  tools/      kernel benchmarks, the roofline calibration, the data-path
              benchmarks and the accuracy smoke and regression

Entry points run on the GPU (``device="cuda"``) and raise when CUDA is
absent unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import GlobalConfig  # noqa: F401
