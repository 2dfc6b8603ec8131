"""Modality-rebuild training CLI (``deepsense6g_tii_tpu/cli/rebuild.py``):
the same flags with the same defaults, on the GPU.

    python -m deepsense6g_tii_tpu_torch.cli.rebuild -s lidar radar -t image \\
        --data_root ROOT --fusion_model_path log/run/best_model.pt

Trains the rebuild heads (and the fusion model at lr 1e-6) on the
development and adaptation sets together, split 90/10 with seed 100;
validates each epoch with the rebuilt features injected (per-scenario and
overall DBA) and keeps the 5-way best/final checkpoints
(``cli/rebuild_engine_io.py``).  ``--Val 1 [--load_model_dir DIR]``
validates only; ``--finetune 1`` trains without validating or saving.

Under a launcher it trains data-parallel, one process per GPU (the JAX
rebuild CLI always trains over every local chip, ``cli/rebuild.py:
131-135``):

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m deepsense6g_tii_tpu_torch.cli.rebuild -s lidar radar -t image \
        --data_root ROOT --batch_size 8 ...

The CLI joins the process group that its environment describes
(``parallel/distributed.py::initialize``: the launcher's ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, or the JAX package's
``DEEPSENSE_*`` variables; without them it trains in one process, as the
JAX CLI on one chip).  Each rank holds ``cuda:LOCAL_RANK`` and
``--batch_size / N`` rows of every step (``--batch_size`` stays the global
batch and must divide by N) from its shard of the training set
(``data/dataset.py::shard_for_process``), and ``RebuildTrainer(mesh=...)``
computes the global batch's step; validation runs the full split on every
rank; rank 0's logdir is every rank's, and only rank 0 writes it.

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs the plain PyTorch paths (on gloo under a launcher). The fusion model
is the MambaFuser of the config's defaults, random from seed 100 unless
``--fusion_model_path`` names a checkpoint: the port's ``.pt``, a JAX
``.msgpack`` or a reference ``.pth`` (``serve.read_state_dict``).
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import numpy as np

from .train import _geometry_overrides

# the train step's losses: the total, then the terms logged per step
LOSSES = ("loss", "trans", "contrast", "distance", "fusion")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    time_id = datetime.now().strftime("%Y%m%d_%H%M%S")
    p.add_argument("--id", type=str, default=time_id)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("-s", "--source_domain", nargs="+", required=True)
    p.add_argument("-t", "--target_domain", nargs="+", required=True)
    p.add_argument("--data_root", type=str, default="./Dataset")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--logdir", type=str, default="log")
    p.add_argument("--finetune", type=int, default=0)
    p.add_argument("--add_velocity", type=int, default=1)
    p.add_argument("--add_mask", type=int, default=0)
    p.add_argument("--enhanced", type=int, default=1)
    p.add_argument("--filtered", type=int, default=0)
    p.add_argument("--angle_norm", type=int, default=1)
    p.add_argument("--custom_FoV_lidar", type=int, default=1)
    p.add_argument("--add_seg", type=int, default=0)
    p.add_argument("--loss", type=str, default="focal")
    p.add_argument("--scheduler", type=int, default=1)
    p.add_argument("--load_previous_best", type=int, default=0)
    p.add_argument("--temp_coef", type=int, default=1)
    p.add_argument("--Val", type=int, default=0)
    p.add_argument("--modality_missing_type", type=str, default="zerolike")
    p.add_argument("--load_model_dir", type=str, default=None)
    p.add_argument("--fusion_model_path", type=str, default=None,
                   help="pretrained fuser checkpoint (.pt, .msgpack or "
                        ".pth)")
    p.add_argument("--temp", type=float, default=0.1,
                   help="NT-Xent contrastive temperature")
    p.add_argument("--alpha_pred", type=float, default=0.5,
                   help="accepted for reference CLI compatibility; unused "
                        "(the reference parses but never reads it, "
                        "train_image_radar_lidar_rebuild.py:644)")
    p.add_argument("--alpha_trans", type=float, default=1.0)
    p.add_argument("--alpha_contrast", type=float, default=1.0)
    p.add_argument("--alpha_distance", type=float, default=1.0)
    p.add_argument("--alpha_fusion", type=float, default=1.0)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    # model-geometry knobs (the full-width model's when unset), as in
    # cli/train.py
    p.add_argument("--input_resolution", type=int, default=None)
    p.add_argument("--vert_anchors", type=int, default=None)
    p.add_argument("--horz_anchors", type=int, default=None)
    p.add_argument("--n_layer", type=int, default=None)
    p.add_argument("--backbone_blocks", type=str, default=None)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..parallel import distributed
    from ..utils.device import resolve_device

    resolve_device(args.device)        # raises before any group is joined
    if not distributed.initialize():
        return run(args)
    print("distributed:", distributed.process_info())
    try:
        code = run(args)
        distributed.barrier("done")
        return code
    finally:
        distributed.shutdown()


def run(args) -> int:
    """The CLI's work on parsed ``args``, in the process group when one was
    joined."""
    import torch

    from ..config import SCENARIOS, GlobalConfig
    from ..data.dataset import (BeamDataset, ConcatDataset, random_split,
                                shard_for_process)
    from ..data.loader import DataLoader
    from ..models.fuser import BeamFuser
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh
    from ..rebuild.trainer import RebuildOptions, RebuildTrainer
    from ..serve import read_state_dict
    from ..train import checkpoints as ckpt
    from ..train.metrics import compute_acc, compute_dba_score
    from ..train.scheduler import reference_recipe_lr
    from ..utils.device import resolve_device
    from .rebuild_engine_io import load_rebuild_state, save_rebuild_state

    device = resolve_device(args.device)
    target = args.target_domain[0]
    logdir = args.logdir
    if logdir == "log":
        logdir = os.path.join(logdir, args.id)
    mesh = None
    if torch.distributed.is_initialized():
        if device.type == "cuda":
            device = torch.device("cuda", distributed.local_rank())
        mesh = make_mesh(device=device)
        # the default --id is a per-process timestamp: pin every rank to
        # rank 0's logdir
        logdir = distributed.broadcast_str(logdir)
    world = 1 if mesh is None else mesh.world_size
    if args.batch_size % world:
        raise ValueError(f"--batch_size {args.batch_size} must be divisible "
                         f"by the process count {world}")
    os.makedirs(logdir, exist_ok=True)

    cfg = GlobalConfig(
        seq_len=args.seq_len,
        modality_missing=target,
        modality_missing_type=args.modality_missing_type,
        add_velocity=args.add_velocity, add_mask=args.add_mask,
        enhanced=args.enhanced, angle_norm=args.angle_norm,
        custom_FoV_lidar=args.custom_FoV_lidar, filtered=args.filtered,
        add_seg=args.add_seg, data_root=args.data_root,
        compute_dtype=args.compute_dtype,
        **_geometry_overrides(args))

    # dev + adaptation merged, 90/10 (the reference's lines 690-700)
    development = BeamDataset(cfg.data_root + "/Multi_Modal/",
                              "ml_challenge_dev_multi_modal.csv", cfg)
    adaptation = BeamDataset(
        cfg.data_root + "/Adaptation_dataset_multi_modal/",
        "ml_challenge_data_adaptation_multi_modal.csv", cfg)
    full = ConcatDataset([development, adaptation])
    n_train = int(0.9 * len(full))
    train_set, val_set = random_split(full, [n_train, len(full) - n_train])
    # --batch_size is the global batch, split over the ranks; validation
    # feeds the full batch of the full split to every rank
    train_loader = DataLoader(shard_for_process(train_set),
                              args.batch_size // world, shuffle=True,
                              num_workers=args.num_workers)
    val_loader = DataLoader(val_set, args.batch_size,
                            num_workers=args.num_workers)

    # random weights from seed 100, as the JAX CLI's init
    model = BeamFuser(cfg, device=device,
                      generator=torch.Generator().manual_seed(100))
    if args.fusion_model_path:
        model.load_state_dict(read_state_dict(args.fusion_model_path, cfg),
                              strict=True)
    opts = RebuildOptions(
        source_domain=tuple(args.source_domain), target_domain=target,
        alpha_trans=args.alpha_trans, alpha_contrast=args.alpha_contrast,
        alpha_distance=args.alpha_distance, alpha_fusion=args.alpha_fusion,
        temp=args.temp, lr=args.lr)
    trainer = RebuildTrainer(model, cfg, opts, device=device, mesh=mesh)
    trainer.init_state()

    lead = distributed.process_index() == 0
    # rank 0 alone logs: the other ranks' lines would double the stream
    logger = ckpt.ScalarLogger(logdir) if lead else ckpt.NullLogger()
    ckpt.write_args(logdir, vars(args))         # rank 0's

    def load_written(folder):
        """Loads a logdir's best files once rank 0's writes have landed."""
        ckpt.flush()
        distributed.barrier("load_rebuild_state")
        load_rebuild_state(folder, trainer, best=True)
    bestval, best_epoch = 0.0, 0
    train_losses, val_losses, dbas = [], [], []

    def run_validation():
        preds, gts, scens, losses = [], [], [], []
        for bi, batch in enumerate(val_loader):
            m = trainer.eval_step(batch, bi)
            preds.append(m["ranks"])
            gts.append(np.asarray(batch["beamidx"]))
            scens.append(np.asarray(batch["scenario"]))
            if "loss" in m:
                losses.append(m["loss"])
        # one read-back for the whole validation
        preds_a = torch.cat(preds).cpu().numpy()
        loss = float(torch.stack(losses).mean()) if losses else 0.0
        gts_a = np.concatenate(gts)
        scens_a = np.concatenate(scens)
        for s in SCENARIOS:
            mask = scens_a == s
            if mask.sum():
                print(s, "acc:", compute_acc(preds_a[mask], gts_a[mask]),
                      "DBA:", compute_dba_score(preds_a[mask], gts_a[mask]))
        return compute_dba_score(preds_a, gts_a), loss

    if args.Val:
        # eval only: rebuilt-feature injection with loaded heads
        if args.load_model_dir:
            load_written(args.load_model_dir)
        dba, _ = run_validation()
        print("Val DBA:", dba)
        print("Val finish")
        return 0

    for epoch in range(args.epochs):
        lr = reference_recipe_lr(epoch, args.lr) if args.scheduler else args.lr
        print("epoch:", epoch, "lr:", lr)
        rows = []
        for batch in train_loader:
            out = trainer.train_step(batch, lr)
            rows.append(torch.stack([out[k] for k in LOSSES]))
        vals = torch.stack(rows).cpu().numpy()   # one read-back an epoch
        step0 = trainer.state.step - len(rows)
        for i, row in enumerate(vals):
            for k, v in zip(LOSSES[1:], row[1:]):
                logger.scalar(f"curr_iter_loss_{k}", float(v), step0 + i + 1)
        train_losses.append(float(vals[:, 0].mean()))
        logger.scalar("curr_loss_train", train_losses[-1], epoch + 1)

        if args.finetune:
            continue

        # validation with rebuilt-feature injection
        dba, val_loss = run_validation()
        dbas.append(dba)
        val_losses.append(val_loss)
        print("Val DBA:", dba)
        logger.scalar("DBA_score_val/scenario_all", dba, epoch + 1)
        logger.scalar("curr_loss_val", val_loss, epoch + 1)

        # 5-way checkpointing (the reference's save(), lines 566-611)
        save_best = dba >= bestval
        if save_best:
            bestval, best_epoch = dba, epoch + 1
        save_rebuild_state(logdir, trainer, best=save_best)
        ckpt.write_run_record(logdir, {
            "epoch": epoch + 1, "iter": trainer.state.step,
            "bestval": bestval, "bestval_epoch": best_epoch,
            "train_loss": train_losses, "val_loss": val_losses, "DBA": dbas})
        if save_best:
            print("====== Overwrote best model ======>")
        elif args.load_previous_best:
            load_written(logdir)
            print("====== Load the previous best model ======>")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
