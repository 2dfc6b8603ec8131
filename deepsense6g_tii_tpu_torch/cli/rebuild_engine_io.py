"""Rebuild-state checkpoints in the reference's 5-module layout
(``deepsense6g_tii_tpu/cli/rebuild_engine_io.py``).

The reference saves the three projection heads, the translator and the
fusion model as separate ``best_``/``final_`` files
(train_image_radar_lidar_rebuild.py:585-611), so each module loads on its
own.  The port writes ``torch.save`` files of each module's state_dict,
keyed by the flax scope names (``train/checkpoints.py``):

  {final,best}_{image,lidar,radar}_projection_l1.pt
  {final,best}_feat_trans_l1.pt
  {final,best}_fusion_model.pt
  best_optim.pt       AdamW's state (both parameter groups)

It also reads a JAX logdir: a module with no ``.pt`` file is read from the
``.msgpack`` of the same stem (``models/msgpack.py``, mapped by
``models/weights.py::from_jax_variables``).  optax's ``best_optim.msgpack``
has no torch counterpart: the optimizer state then starts fresh, and the
loader says so in one line.

In a process group only rank 0 writes (``train/checkpoints.py``); every
rank reads the same files, after the barrier that the rebuild CLI holds
before a read, so the ranks stay bit-equal.
"""

from __future__ import annotations

import os

from ..models.msgpack import read_flax_msgpack
from ..models.weights import from_jax_variables
from ..rebuild.trainer import HEAD_KEYS
from ..train import checkpoints as ckpt


def save_rebuild_state(logdir: str, trainer, best: bool = False) -> None:
    """The final files, and with ``best`` also the best files and the
    optimizer's state."""
    st = trainer.state
    for prefix in ["final"] + (["best"] if best else []):
        for key in HEAD_KEYS:
            ckpt.save_model(logdir, f"{prefix}_{key}",
                            getattr(st.heads, key))
        ckpt.save_model(logdir, f"{prefix}_fusion_model", st.fusion_model)
    if best:
        ckpt.save_optim(logdir, "best_optim", st.optimizer, ema={})


def _load_module(logdir: str, name: str, module) -> None:
    if os.path.isfile(ckpt.model_path(logdir, name)):
        ckpt.load_model(logdir, name, module)
        return
    module.load_state_dict(from_jax_variables(read_flax_msgpack(
        os.path.join(logdir, name + ".msgpack"))), strict=True)


def load_rebuild_state(logdir: str, trainer, best: bool = True) -> None:
    """Loads the heads, the fusion model and (best only) the optimizer's
    state into ``trainer.state`` in place.  The frozen stem+stage1 copies
    are left as they are, as in the JAX package."""
    st = trainer.state
    prefix = "best" if best else "final"
    for key in HEAD_KEYS:
        _load_module(logdir, f"{prefix}_{key}", getattr(st.heads, key))
    _load_module(logdir, f"{prefix}_fusion_model", st.fusion_model)
    if not best:
        return
    if os.path.isfile(ckpt.model_path(logdir, "best_optim")):
        ckpt.load_optim(logdir, "best_optim", st.optimizer)
    elif os.path.isfile(os.path.join(logdir, "best_optim.msgpack")):
        print(f"{logdir}/best_optim.msgpack is optax state: the optimizer "
              f"state starts fresh")
