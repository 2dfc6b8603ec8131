"""Zero-data quickstart: the whole training path on a synthetic demo tree
(the JAX package's ``examples/quickstart.py``).

Writes a small tree in the DeepSense 6G layout (camera JPEGs, LiDAR .ply,
radar .npy, GPS .txt and the index CSVs; ``utils/demo_data.py``), then
drives the training CLI end to end with the real model at a debug
geometry:

  1. train ``--epochs`` epochs (2 by default; EMA, validation, checkpoints,
     the run record and scalars);
  2. ``--Test 1``: the best model writes beam_pred.csv and
     beam_pred_confidence_seq.csv into the work directory, the original
     pipeline's formats;
  3. list the artifacts (the port's checkpoints are ``.pt`` files).

``--device`` defaults to ``cuda`` (bf16 through the hand-written kernels)
and raises without it; ``--device cpu`` runs f32 on the plain paths.

    python -m deepsense6g_tii_tpu_torch.examples.quickstart \\
        [--workdir DIR] [--device cuda] [--epochs 2]

Returns 0 when every artifact exists.
"""

from __future__ import annotations

import argparse
import os

ARTIFACTS = ("final_model.pt", "best_model.pt", "recent.log", "args.txt",
             "scalars.jsonl")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default="./quickstart_out")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--epochs", type=int, default=2)
    args = ap.parse_args(argv)

    from ..cli import train as cli
    from ..utils.demo_data import make_demo_root
    from ..utils.device import resolve_device

    on_card = resolve_device(args.device).type == "cuda"
    workdir = os.path.abspath(args.workdir)
    data_root = os.path.join(workdir, "demo_dataset")
    logdir = os.path.join(workdir, "log", "quickstart")
    os.makedirs(data_root, exist_ok=True)
    if not os.path.exists(os.path.join(
            data_root, "Multi_Modal", "ml_challenge_dev_multi_modal.csv")):
        print("==> writing the synthetic demo tree at", data_root)
        make_demo_root(data_root, n_train=3, n_adapt=2, n_test=2, seq_len=2)

    # the real BeamFuser, shrunk by the debug-geometry flags
    common = [
        "--data_root", data_root, "--logdir", logdir,
        "--device", args.device, "--seq_len", "2", "--batch_size", "4",
        "--augmentation", "0", "--scheduler", "0", "--num_workers", "2",
        "--compute_dtype", "bfloat16" if on_card else "float32",
        "--input_resolution", "64", "--vert_anchors", "2",
        "--horz_anchors", "2", "--n_layer", "1",
        "--backbone_blocks", "1,1,1,1",
    ]

    print(f"==> training {args.epochs} epoch(s)")
    rc = cli.main(common + ["--epochs", str(args.epochs), "--ema", "1"])
    if rc:
        return rc

    print("==> test-split prediction (beam_pred.csv)")
    cwd = os.getcwd()
    os.chdir(workdir)        # the CSV writers write into the working
    try:                     # directory, as the original pipeline does
        rc = cli.main(common + ["--Test", "1"])
    finally:
        os.chdir(cwd)
    if rc:
        return rc

    print("\n==> artifacts")
    paths = [os.path.join(logdir, f) for f in ARTIFACTS]
    pred = os.path.join(workdir, "beam_pred.csv")
    missing = 0
    for p in paths + [pred]:
        ok = os.path.exists(p)
        missing += not ok
        print(f"  {p}  {'OK' if ok else 'MISSING'}")
    if os.path.exists(pred):
        print("\nbeam_pred.csv:")
        with open(pred) as f:
            print(f.read().strip())
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
