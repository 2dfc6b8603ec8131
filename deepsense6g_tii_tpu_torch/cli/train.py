"""Training / validation / test CLI (``deepsense6g_tii_tpu/cli/train.py``):
the same flags with the same defaults, on the GPU.

    python -m deepsense6g_tii_tpu_torch.cli.train --data_root ROOT --id run1 \\
        --epochs 150 --batch_size 8 --ema 1 [--Test 1 | --Val 1]

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device cpu``
runs every kernel's plain PyTorch version on the CPU.  ``--flash_attention``
auto means the flash kernels on the card.  ``--compute_dtype`` keeps the
JAX default, bfloat16.

``--pred_len 5 --seq_len 10 --grad_clip 3.0`` trains the 30-to-5
multi-step variant.  ``--load_torch_checkpoint PATH`` imports a reference
``.pth`` into the model and the EMA shadow before training, validating or
testing (after ``--load_model_path`` or a resume, as in the JAX CLI).

``--cache_dir DIR`` featurizes the train and validation sets once into
memmaps under ``DIR/train`` and ``DIR/val`` (data/cache.py; a later run
finds them and builds nothing) and trains from them; ``--Test`` reads the
raw tree, as in the JAX CLI.

``--multihost`` (a later slice) raises ``NotImplementedError`` naming its
ROADMAP.md item.  So do the TPU knobs the port does not take:
``--merge_lidar_radar``, ``--padded_token_stream``, ``--flatten_accum``,
``--opt_mu_dtype bfloat16`` and ``--flash_dropout_impl hw``.  ``--remat``
is accepted and ignored.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    time_id = datetime.now().strftime("%Y%m%d_%H%M%S")
    p.add_argument("--id", type=str, default=time_id,
                   help="Unique experiment identifier.")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--logdir", type=str, default="log")
    p.add_argument("--add_velocity", type=int, default=1,
                   help="concatenate velocity map with angle map")
    p.add_argument("--FFM", type=int, default=1, help="Feature Fusion Mamba")
    p.add_argument("--TFM", type=int, default=1, help="Time Fusion Mamba")
    p.add_argument("--add_mask", type=int, default=0)
    p.add_argument("--enhanced", type=int, default=1)
    p.add_argument("--filtered", type=int, default=0)
    p.add_argument("--loss", type=str, default="focal",
                   help="ce or focal loss")
    p.add_argument("--scheduler", type=int, default=1)
    p.add_argument("--load_previous_best", type=int, default=0)
    p.add_argument("--temp_coef", type=int, default=1)
    p.add_argument("--train_adapt_together", type=int, default=1)
    p.add_argument("--finetune", type=int, default=0)
    p.add_argument("--Val", type=int, default=0)
    p.add_argument("--Test", type=int, default=0)
    p.add_argument("--modality_missing", type=str, default=None)
    p.add_argument("--modality_missing_type", type=str, default="zerolike")
    p.add_argument("--load_model_path", type=str, default=None)
    p.add_argument("--augmentation", type=int, default=1)
    p.add_argument("--angle_norm", type=int, default=1)
    p.add_argument("--custom_FoV_lidar", type=int, default=1)
    p.add_argument("--add_seg", type=int, default=0)
    p.add_argument("--ema", type=int, default=0)
    p.add_argument("--flip", type=int, default=0)
    p.add_argument("--data_root", type=str, default="./Dataset")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--cache_dir", type=str, default=None,
                   help="pre-featurized array cache directory (memmaps, "
                        "built at the first run)")
    p.add_argument("--pred_len", type=int, default=1)
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--grad_clip", type=float, default=None)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--remat", type=str, default="none",
                   choices=["0", "1", "none", "fusion", "conv", "stem"],
                   help="accepted for the JAX CLI's sake and ignored")
    p.add_argument("--steps_per_dispatch", type=int, default=1,
                   help="optimizer steps per dispatch; the port runs them "
                        "one after another")
    p.add_argument("--grad_accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer "
                        "step (batch must divide evenly)")
    p.add_argument("--flatten_accum", type=int, default=0,
                   help="a TPU dispatch knob (raises)")
    p.add_argument("--opt_mu_dtype", type=str, default=None,
                   choices=["bfloat16", "float32"],
                   help="Adam first-moment dtype: float32 only (bfloat16 "
                        "raises)")
    # model-geometry knobs; the defaults are the full-width model's
    p.add_argument("--input_resolution", type=int, default=None,
                   help="input image/BEV/radar side (default 256)")
    p.add_argument("--vert_anchors", type=int, default=None)
    p.add_argument("--horz_anchors", type=int, default=None)
    p.add_argument("--n_layer", type=int, default=None,
                   help="fusion blocks per scale (default 8)")
    p.add_argument("--backbone_blocks", type=str, default=None,
                   help="comma-separated per-stage block counts, "
                        "e.g. 1,1,1,1 (default: ResNet34/18 depths)")
    p.add_argument("--flash_attention", type=int, default=None,
                   help="flash-attention kernels for the GPT fusion blocks "
                        "(--FFM 0); default: on with --device cuda")
    p.add_argument("--flash_dropout_impl", type=str, default=None,
                   choices=("hash", "hw"),
                   help="attention-dropout stream: hash (hw, the TPU's "
                        "hardware PRNG, raises)")
    p.add_argument("--merge_lidar_radar", type=int, default=0,
                   help="a TPU lowering knob (raises)")
    p.add_argument("--padded_token_stream", type=int, default=0,
                   help="a TPU lowering knob (raises)")
    p.add_argument("--multihost", type=int, default=0,
                   help="multi-GPU training (not in the port yet: raises)")
    p.add_argument("--load_torch_checkpoint", type=str, default=None,
                   help="import a reference .pth into the model")
    return p


def mangle_logdir(args) -> str:
    """The logdir suffix rules: log/<id>, -ms_<modality>-<type>, _val."""
    logdir = args.logdir
    if logdir == "log":
        logdir = os.path.join(logdir, args.id)
    if args.modality_missing is not None:
        logdir = logdir + "-ms_" + args.modality_missing
        logdir = logdir + "-" + args.modality_missing_type
    if args.Val:
        logdir = logdir + "_val"
    return logdir


_LATER = (
    ("multihost", bool, "multi-GPU training (ROADMAP.md Queue 1 item 7)"),
)
_TPU_KNOBS = (
    ("merge_lidar_radar", bool),
    ("padded_token_stream", bool),
    ("flatten_accum", bool),
    ("opt_mu_dtype", lambda v: v == "bfloat16"),
    ("flash_dropout_impl", lambda v: v == "hw"),
)


def check_args(args) -> None:
    """Raises NotImplementedError for the flags the port does not take."""
    for flag, given, what in _LATER:
        if given(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag}: {what} is not in the PyTorch port yet")
    for flag, given in _TPU_KNOBS:
        if given(getattr(args, flag)):
            raise NotImplementedError(
                f"--{flag} {getattr(args, flag)}: a TPU knob the PyTorch "
                f"port does not take (ROADMAP.md, Out of scope)")


def config_from_args(args):
    from ..config import GlobalConfig
    flash = args.flash_attention
    if flash is None:       # auto: the kernels on the card
        flash = args.device != "cpu"
    return GlobalConfig(
        use_flash_attention=bool(flash),
        flash_dropout_impl=args.flash_dropout_impl,
        seq_len=args.seq_len,
        pred_len=args.pred_len,
        data_root=args.data_root,
        FFM=args.FFM, TFM=args.TFM,
        modality_missing=args.modality_missing,
        modality_missing_type=args.modality_missing_type,
        add_velocity=args.add_velocity,
        add_mask=args.add_mask,
        enhanced=args.enhanced,
        angle_norm=args.angle_norm,
        custom_FoV_lidar=args.custom_FoV_lidar,
        filtered=args.filtered,
        add_seg=args.add_seg,
        compute_dtype=args.compute_dtype,
        remat={"0": "none", "1": "fusion"}.get(args.remat, args.remat),
        opt_mu_dtype=(None if args.opt_mu_dtype in (None, "float32")
                      else args.opt_mu_dtype),
        merge_lidar_radar=bool(args.merge_lidar_radar),
        padded_token_stream=bool(args.padded_token_stream),
        **_geometry_overrides(args),
    )


def _geometry_overrides(args):
    """Only explicitly passed geometry flags reach GlobalConfig."""
    kw = {}
    if args.input_resolution is not None:
        kw["input_resolution"] = args.input_resolution
        kw["crop"] = args.input_resolution
    for f in ("vert_anchors", "horz_anchors", "n_layer"):
        if getattr(args, f) is not None:
            kw[f] = getattr(args, f)
    if args.backbone_blocks:
        kw["backbone_blocks"] = tuple(
            int(x) for x in args.backbone_blocks.split(","))
    return kw


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    check_args(args)

    import torch

    from ..data.dataset import BeamDataset, build_train_val_sets
    from ..data.loader import DataLoader
    from ..models.fuser import BeamFuser
    from ..train import checkpoints as ckpt
    from ..train.engine import Engine, TrainOptions
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    logdir = mangle_logdir(args)
    os.makedirs(logdir, exist_ok=True)

    cfg = config_from_args(args)
    data_root = cfg.data_root
    trainval_root = data_root + "/Multi_Modal/"
    train_root_csv = "ml_challenge_dev_multi_modal.csv"
    adaptation_root = data_root + "/Adaptation_dataset_multi_modal/"
    adaptation_csv = "ml_challenge_data_adaptation_multi_modal.csv"

    opts = TrainOptions(
        logdir=logdir, epochs=args.epochs, lr=args.lr,
        loss=args.loss, scheduler=bool(args.scheduler),
        ema=bool(args.ema), temp_coef=bool(args.temp_coef),
        load_previous_best=bool(args.load_previous_best),
        finetune=bool(args.finetune), clip_grad_norm=args.grad_clip,
        steps_per_dispatch=args.steps_per_dispatch,
        grad_accum=args.grad_accum)

    # random weights from the run's seed, as the JAX engine's init
    model = BeamFuser(cfg, device=device,
                      generator=torch.Generator().manual_seed(opts.seed))
    engine = Engine(model, cfg, opts, device=device)
    ckpt.write_args(logdir, vars(args))

    def load_model_path():
        d, name = os.path.split(args.load_model_path)
        engine.load_weights(name.removesuffix(".pt"), logdir=d)

    def maybe_import_torch_weights():
        """A reference .pth into the model and the EMA shadow."""
        if not args.load_torch_checkpoint:
            return
        from ..models.checkpoint_import import load_reference_checkpoint
        from ..models.weights import from_jax_variables
        params, stats, unused = load_reference_checkpoint(
            args.load_torch_checkpoint, cfg)
        if unused:
            print(f"======WARNING: {len(unused)} unused torch keys, e.g. "
                  f"{sorted(unused)[:3]}")
        if engine.state is None:
            engine.init_state()
        engine.model.load_state_dict(from_jax_variables(
            {"params": params, "batch_stats": stats}), strict=True)
        with torch.no_grad():
            for n, p in engine.model.named_parameters():
                engine.state.ema[n].copy_(p.detach())
        print("======imported torch checkpoint", args.load_torch_checkpoint)

    if args.Test:
        test_root = data_root + "/Multi_Modal_Test/"
        test_set = BeamDataset(test_root, "ml_challenge_test_multi_modal.csv",
                               cfg, test=True)
        print("test_set:", len(test_set))
        loader = DataLoader(test_set, args.batch_size,
                            num_workers=args.num_workers)
        engine.init_state()
        if args.load_model_path:
            load_model_path()
        elif engine.resume():
            engine.load_weights("best_model")
        maybe_import_torch_weights()
        engine.test(loader)
        print("Test finish")
        return 0

    train_set, val_set = build_train_val_sets(
        cfg, trainval_root=trainval_root, train_root_csv=train_root_csv,
        adaptation_root=adaptation_root, adaptation_csv=adaptation_csv,
        train_adapt_together=bool(args.train_adapt_together),
        finetune=bool(args.finetune), augmentation=bool(args.augmentation),
        flip=bool(args.flip))
    print("train_set:", len(train_set),
          "val_set:", len(val_set) if val_set else 0)

    if args.cache_dir:
        from ..data.cache import CachedDataset, build_cache
        train_set = CachedDataset(build_cache(
            train_set, os.path.join(args.cache_dir, "train")))
        if val_set is not None:
            val_set = CachedDataset(build_cache(
                val_set, os.path.join(args.cache_dir, "val")))

    val_loader = (DataLoader(val_set, args.batch_size,
                             num_workers=args.num_workers)
                  if val_set is not None else None)

    if args.Val:
        engine.init_state()
        if args.load_model_path:
            load_model_path()
        maybe_import_torch_weights()
        engine.validate(val_loader)
        print("Val finish")
        return 0

    train_loader = DataLoader(train_set, args.batch_size, shuffle=True,
                              num_workers=args.num_workers)
    if engine.resume() and args.finetune:
        engine.init_state()
        try:
            engine.load_weights("all_finetune_on_final_model")
        except FileNotFoundError:
            engine.load_weights("final_model")

    maybe_import_torch_weights()
    for epoch in range(engine.cur_epoch, args.epochs):
        print("epoch:", epoch, "lr:", engine._lr())
        engine.train(train_loader)
        if not args.finetune:
            engine.validate(val_loader)
            engine.save()
    ckpt.flush()    # land the final epoch's async checkpoint writes
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
