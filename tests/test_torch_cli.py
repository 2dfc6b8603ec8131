"""The port's train CLI (deepsense6g_tii_tpu_torch/cli/train.py): its flag
surface against the JAX CLI's, the flags it refuses, and whole runs of
``main`` on the CPU on a demo tree (the real GPT TransFuser at the small
test geometry, f32): train, resume, --Test and --Val.  Only the parser
comparison imports the JAX package.
"""

import csv
import inspect
import json
import os

import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.cli import train as jcli
from deepsense6g_tii_tpu_torch.cli import train as cli
from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

# flags that raise NotImplementedError, with a value that triggers it
RAISING = {
    "multihost": "1", "merge_lidar_radar": "1",
    "padded_token_stream": "1", "flatten_accum": "1",
    "opt_mu_dtype": "bfloat16", "flash_dropout_impl": "hw",
}
# flags that raised until the 30-to-5 variant, the reference import and
# the memmap cache were ported; runs of main with them:
# tests/test_torch_30to5.py, test_main_cache_dir_builds_then_reuses below
PORTED = {"load_torch_checkpoint": "x.pth", "pred_len": "5",
          "cache_dir": "cache"}
SMALL_FLAGS = ["--seq_len", "2", "--compute_dtype", "float32",
               "--input_resolution", "64", "--vert_anchors", "2",
               "--horz_anchors", "2", "--n_layer", "1",
               "--backbone_blocks", "1,1,1,1", "--FFM", "0", "--TFM", "0",
               "--num_workers", "2", "--batch_size", "4"]




def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_jax_flag_parses_with_equal_defaults():
    want = vars(jcli.build_parser().parse_args(["--id", "x"]))
    got = vars(cli.build_parser().parse_args(["--id", "x"]))
    assert set(got) == set(want)
    for key in want:
        if key == "device":
            assert (got[key], want[key]) == ("cuda", "tpu")
        else:
            assert got[key] == want[key], key
    ja, pa = _actions(jcli.build_parser()), _actions(cli.build_parser())
    for dest, a in ja.items():
        assert pa[dest].option_strings == a.option_strings
        assert pa[dest].type == a.type and pa[dest].choices == a.choices


def test_reference_flags_accepted():
    args = cli.build_parser().parse_args([
        "--id", "x", "--epochs", "150", "--lr", "1e-4",
        "--batch_size", "12", "--add_velocity", "1", "--FFM", "1",
        "--TFM", "1", "--add_mask", "0", "--enhanced", "1",
        "--filtered", "0", "--loss", "focal", "--scheduler", "1",
        "--load_previous_best", "0", "--temp_coef", "1",
        "--train_adapt_together", "1", "--finetune", "0", "--Val", "0",
        "--Test", "0", "--modality_missing", "radar",
        "--modality_missing_type", "randlike", "--augmentation", "1",
        "--angle_norm", "1", "--custom_FoV_lidar", "1", "--add_seg", "0",
        "--ema", "1", "--flip", "0", "--device", "cpu", "--remat", "1",
        "--opt_mu_dtype", "float32", "--flash_dropout_impl", "hash"])
    cli.check_args(args)            # accepted: remat ignored, f32 mu, hash
    cfg = cli.config_from_args(args)
    assert cfg.modality_missing == "radar" and cfg.n_tokens == 962
    assert cfg.compute_dtype == "bfloat16" and cfg.opt_mu_dtype is None


@pytest.mark.parametrize("flag", sorted({**RAISING, **PORTED}))
def test_unported_flags_raise(flag, tmp_path):
    if flag in PORTED:
        args = cli.build_parser().parse_args([f"--{flag}", PORTED[flag]])
        cli.check_args(args)                 # accepted now
        cfg = cli.config_from_args(args)
        assert {"pred_len": cfg.pred_len == 5,
                "load_torch_checkpoint": args.load_torch_checkpoint
                == "x.pth", "cache_dir": args.cache_dir == "cache"}[flag]
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--device", "cpu", "--logdir", str(tmp_path / "r"),
                  f"--{flag}", RAISING[flag]])
    assert not os.path.exists(tmp_path / "r")


@pytest.mark.parametrize("argv", [
    ["--id", "exp1"],
    ["--id", "exp1", "--modality_missing", "image", "--Val", "1"],
    ["--logdir", "runs/a", "--modality_missing", "lidar",
     "--modality_missing_type", "randlike"],
    ["--logdir", "runs/b", "--Val", "1"],
])
def test_mangle_logdir_matches_jax(argv):
    assert (cli.mangle_logdir(cli.build_parser().parse_args(argv))
            == jcli.mangle_logdir(jcli.build_parser().parse_args(argv)))


def test_flash_attention_auto_means_the_card():
    p = cli.build_parser()
    assert cli.config_from_args(p.parse_args([])).use_flash_attention
    assert not cli.config_from_args(
        p.parse_args(["--device", "cpu"])).use_flash_attention
    assert cli.config_from_args(p.parse_args(
        ["--device", "cpu", "--flash_attention", "1"])).use_flash_attention


def test_main_defaults_to_cuda_and_raises_without_it(monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--logdir", str(tmp_path / "r")])


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    return make_demo_root(str(tmp_path_factory.mktemp("demo")), n_train=3,
                          n_adapt=3, n_test=2, seq_len=2)


@pytest.fixture(scope="module")
def trained(demo, tmp_path_factory):
    """2 epochs, then a second main resuming to a 3rd."""
    logdir = str(tmp_path_factory.mktemp("run") / "r")
    base = ["--device", "cpu", "--data_root", demo, "--logdir", logdir,
            "--augmentation", "0", "--ema", "1", "--scheduler", "1",
            *SMALL_FLAGS]
    assert cli.main(base + ["--epochs", "2"]) == 0
    first = json.load(open(os.path.join(logdir, "recent.log")))
    assert cli.main(base + ["--epochs", "3"]) == 0
    return logdir, first


def test_main_trains_and_resumes(trained):
    logdir, first = trained
    assert first["epoch"] == 2 and first["iter"] == 6
    rec = json.load(open(os.path.join(logdir, "recent.log")))
    assert rec["epoch"] == 3 and rec["iter"] == 9
    assert rec["train_loss"][:2] == first["train_loss"]
    assert len(rec["DBA"]) == len(rec["val_loss"]) == 3
    assert np.isfinite(rec["train_loss"]).all()
    for name in ("final_model", "best_model", "best_optim"):
        assert os.path.isfile(os.path.join(logdir, f"{name}.pt"))
    args = json.load(open(os.path.join(logdir, "args.txt")))
    assert args["epochs"] == 3 and args["device"] == "cpu"
    tags = {json.loads(line)["tag"]
            for line in open(os.path.join(logdir, "scalars.jsonl"))}
    assert {"perf/samples_per_sec", "perf/data_wait_share",
            "DBA_score_val/scenario_all", "curr_loss_train"} <= tags
    assert any(n.startswith("events.out.tfevents") for n in
               os.listdir(logdir))


def test_main_test_writes_beam_pred(trained, demo, tmp_path, monkeypatch):
    logdir, _ = trained
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--device", "cpu", "--data_root", demo,
                     "--logdir", str(tmp_path / "t"), "--Test", "1",
                     "--load_model_path",
                     os.path.join(logdir, "best_model"), *SMALL_FLAGS]) == 0
    rows = list(csv.reader(open(tmp_path / "beam_pred.csv")))
    assert rows[0] == ["index", "top-1 beam", "top-2 beam", "top-3 beam"]
    assert len(rows) == 1 + 4
    assert all(1 <= int(b) <= 64 for r in rows[1:] for b in r[1:])
    conf = list(csv.reader(open(tmp_path / "beam_pred_confidence_seq.csv")))
    assert len(conf) == 1 + 4
    assert all(0 < float(r[1]) <= 1 for r in conf[1:])


def test_main_val_runs(demo, tmp_path, capsys):
    logdir = str(tmp_path / "v")
    assert cli.main(["--device", "cpu", "--data_root", demo, "--logdir",
                     logdir, "--Val", "1", "--augmentation", "0",
                     *SMALL_FLAGS]) == 0
    assert "Val finish" in capsys.readouterr().out
    assert os.path.isdir(logdir + "_val")
    assert not os.path.exists(os.path.join(logdir + "_val", "final_model.pt"))


def test_entry_point_signatures():
    assert "argv" in inspect.signature(cli.main).parameters
    assert cli.build_parser().get_default("device") == "cuda"
    assert cli.build_parser().get_default("compute_dtype") == "bfloat16"


def test_main_cache_dir_builds_then_reuses(demo, tmp_path):
    """--cache_dir featurizes the train and validation sets once (the
    files byte-equal to the JAX package's build of the same sets, as
    tests/test_torch_cache.py holds) and trains from them; a second run
    finds the caches, writes nothing to them and, from the same seed,
    trains the same losses."""
    cache_dir = str(tmp_path / "cache")
    base = ["--device", "cpu", "--data_root", demo, "--augmentation", "0",
            "--epochs", "1", "--cache_dir", cache_dir, *SMALL_FLAGS]
    assert cli.main(base + ["--logdir", str(tmp_path / "a")]) == 0
    manifests = {sub: os.path.join(cache_dir, sub, "manifest.json")
                 for sub in ("train", "val")}
    mtimes = {sub: os.stat(m).st_mtime_ns for sub, m in manifests.items()}
    n = {sub: json.load(open(m))["n"] for sub, m in manifests.items()}
    assert n == {"train": 10, "val": 2}             # 90/10 of 12 samples
    assert cli.main(base + ["--logdir", str(tmp_path / "b")]) == 0
    assert mtimes == {sub: os.stat(m).st_mtime_ns
                      for sub, m in manifests.items()}
    a, b = (json.load(open(tmp_path / d / "recent.log")) for d in "ab")
    assert a["train_loss"] == b["train_loss"] and np.isfinite(
        a["train_loss"]).all()
    assert a["val_loss"] == b["val_loss"]
