"""Data parallelism on ``torch.distributed`` (``deepsense6g_tii_tpu/
parallel/``): the process group's set-up (``distributed.py``) and the mesh
that training and serving run over (``mesh.py``).

The JAX package runs one process over all local chips and spans hosts
after ``jax.distributed.initialize``.  The port runs PyTorch's way: one
process per GPU (``python -m torch.distributed.run``), NCCL between cards
and gloo on the CPU.  Inside one serving process, several local devices
hold replicas of the model (``serve.Predictor(use_mesh=True)``).
"""
