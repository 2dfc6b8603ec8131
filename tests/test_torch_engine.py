"""The port's Engine (deepsense6g_tii_tpu_torch/train/engine.py) against the
JAX package's, and its checkpoint and EMA policy on its own.

Parity: both engines train the GPT TransFuser at the small test geometry
(n_layer 1, f32, dropout 0, lr 1e-6) for 2 epochs from the same JAX
``init_state`` variables, each reading the same demo tree through its own
package's data path, with a ragged last training batch (10 samples in
batches of 4), then validate, checkpoint and test (2 and 4 samples in
batches of 2: one eval shape, so the JAX side compiles it once).  The JAX
side runs its einsum attention (no Pallas kernel in interpret mode) on a
1-device mesh; the port runs the flash kernel's plain version.  Both take
the same batches in the same order (tests/test_torch_data.py), so the two
runs differ only in f32 rounding and in AdamW's sign flips where a gradient
element is near 0 (tests/test_torch_train.py explains both): each step can
move an element up to 2 lr apart.  At lr 1e-4 that drift reaches the
outputs (measured: epoch-2 train loss 5.6e-3 apart relative, test
confidences 4.8e-2, every parameter still within the envelope); at lr 1e-6
every gap shrinks a hundredfold or more (the measured gaps below), so the
comparison is tight enough to see an engine fault.
"""

import csv
import json
import os

import jax
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.data import dataset as jds
from deepsense6g_tii_tpu.data import loader as jloader
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.parallel.mesh import make_mesh
from deepsense6g_tii_tpu.runtime import native as jnative
from deepsense6g_tii_tpu.train import engine as jengine
from deepsense6g_tii_tpu.utils.demo_data import make_demo_root
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.data import dataset as pds
from deepsense6g_tii_tpu_torch.data import loader as ploader
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.train import checkpoints as ckpt
from deepsense6g_tii_tpu_torch.train import engine as pengine
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

SMALL = dict(seq_len=2, n_layer=1, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=0, TFM=0, embd_pdrop=0.0,
             attn_pdrop=0.0, resid_pdrop=0.0)
BATCH, EVAL_BATCH, EPOCHS, LR = 4, 2, 2, 1e-6
STEPS = 3 * EPOCHS
# Bounds, about 10x the gaps measured on an 8-core x86-64 CPU: train loss
# 1.4e-6 and 1.3e-7 apart relative in epochs 1 and 2, validation loss
# 1.5e-6, confidences 7.8e-6, BatchNorm statistics 6.6e-5 of their leaf's
# largest value; parameters 7.3e-6 (the envelope is 1.2e-5).  A near-tie
# (TIE_GAP) is 100x the logit drift those confidences imply.
LOSS_RTOL = 2e-5
VAL_LOSS_RTOL = 2e-5
CONF_RTOL = 1e-4
STATS_RTOL = 1e-3
TIE_GAP = 1e-3




def _splits(root, pkg, cfg):
    kw = dict(trainval_root=root + "/Multi_Modal/",
              train_root_csv="ml_challenge_dev_multi_modal.csv",
              adaptation_root=root + "/Adaptation_dataset_multi_modal/",
              adaptation_csv="ml_challenge_data_adaptation_multi_modal.csv",
              train_adapt_together=True, augmentation=False)
    train, val = pkg.build_train_val_sets(cfg, **kw)
    test = pkg.BeamDataset(root + "/Multi_Modal_Test/",
                           "ml_challenge_test_multi_modal.csv", cfg,
                           test=True)
    return train, val, test


def _run(engine, loaders, out_dir):
    """EPOCHS of train, validate and save; then test.  Returns the train
    DBAs and the validation DBAs."""
    train, val, test = loaders
    dbas = []
    for _ in range(EPOCHS):
        dbas.append((engine.train(train), engine.validate(val)))
        engine.save()
    os.makedirs(out_dir, exist_ok=True)
    engine.test(test, out_dir=out_dir)
    return dbas


INPUTS = ("image", "lidar", "radar", "gps")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("engines")
    root = str(base / "data")
    make_demo_root(root, n_train=3, n_adapt=3, n_test=2, seq_len=2)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "available", lambda: False)   # the Python PLY path
    try:
        jcfg = JaxConfig(**SMALL)
        jsets = _splits(root, jds, jcfg)
        assert [len(s) for s in jsets] == [10, 2, 4]
        jopts = jengine.TrainOptions(logdir=str(base / "jax"), epochs=EPOCHS,
                                     lr=LR, scheduler=False)
        jeng = jengine.Engine(JaxBeamFuser(jcfg), jcfg, jopts,
                              mesh=make_mesh(1))
        jeng.init_state(next(iter(jloader.DataLoader(jsets[0], 1))))
        variables = jax.device_get({"params": jeng.state.params,
                                    "batch_stats": jeng.state.batch_stats})
        jdba = _run(jeng, _loaders(jloader, jsets), str(base / "jax_out"))
        jengine.ckpt.flush()
        final = jax.device_get({"params": jeng.state.params,
                                "batch_stats": jeng.state.batch_stats})
        test_batches = list(jloader.DataLoader(jsets[2], EVAL_BATCH))
    finally:
        mp.undo()

    cfg = GlobalConfig(**{**SMALL, "use_flash_attention": True})
    psets = _splits(root, pds, cfg)
    model = BeamFuser(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    opts = pengine.TrainOptions(logdir=str(base / "port"), epochs=EPOCHS,
                                lr=LR, scheduler=False)
    eng = pengine.Engine(model, cfg, opts, device="cpu")
    pdba = _run(eng, _loaders(ploader, psets), str(base / "port_out"))
    ckpt.flush()
    return dict(jax=jeng, port=eng, jdba=jdba, pdba=pdba, base=base,
                jcfg=jcfg, jvariables=final, test_batches=test_batches,
                jfinal=from_jax_variables(final))


def _jax_test_logits(runs):
    """JAX's test logits on its final weights (one more compile, so only
    when the CSVs differ)."""
    model = JaxBeamFuser(runs["jcfg"])
    apply = jax.jit(lambda v, *x: model.apply(v, *x, train=False))
    return np.concatenate([
        np.asarray(apply(runs["jvariables"], *(b[k] for k in INPUTS)))
        for b in runs["test_batches"]])


def _loaders(pkg, sets):
    return (pkg.DataLoader(sets[0], BATCH, shuffle=True, num_workers=2),
            pkg.DataLoader(sets[1], EVAL_BATCH, num_workers=2),
            pkg.DataLoader(sets[2], EVAL_BATCH, num_workers=2))


def test_train_loss_per_epoch_matches(runs):
    got, want = runs["port"].train_loss, runs["jax"].train_loss
    assert len(got) == len(want) == EPOCHS
    for e in range(EPOCHS):
        assert np.isfinite(got[e])
        np.testing.assert_allclose(got[e], want[e], rtol=LOSS_RTOL)


def test_final_weights_within_adamw_envelope(runs):
    """Every parameter within the sign-flip envelope of the six steps,
    2.02 lr per step; BatchNorm's running statistics within STATS_RTOL of
    their leaf's largest value."""
    got = runs["port"].model.state_dict()
    want = runs["jfinal"]
    assert set(got) == set(want)
    for name, w in want.items():
        err = float((got[name] - w).abs().max())
        top = float(w.abs().max())
        bound = (STATS_RTOL * top if "running" in name
                 else 2.02 * LR * STEPS + 1e-6 * top)
        assert err <= bound, f"{name}: {err:.3g} > {bound:.3g}"


def test_train_and_val_dba_match(runs):
    np.testing.assert_allclose(np.asarray(runs["pdba"]),
                               np.asarray(runs["jdba"]), rtol=0, atol=1e-12)


def test_run_record_matches(runs):
    base = runs["base"]
    got = json.load(open(base / "port" / "recent.log"))
    want = json.load(open(base / "jax" / "recent.log"))
    assert set(got) == set(want)
    for key in ("epoch", "iter", "bestval", "bestval_epoch", "DBA"):
        assert got[key] == pytest.approx(want[key], rel=0, abs=1e-12), key
    assert got["epoch"] == EPOCHS and got["iter"] == STEPS
    np.testing.assert_allclose(got["val_loss"], want["val_loss"],
                               rtol=VAL_LOSS_RTOL)
    for e in range(EPOCHS):
        np.testing.assert_allclose(got["train_loss"][e],
                                   want["train_loss"][e], rtol=LOSS_RTOL)
    for name in ("final_model", "best_model", "best_optim"):
        assert os.path.isfile(base / "port" / f"{name}.pt")


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_test_csvs_match(runs):
    """Rows may differ only where JAX's logits have a near-tie: two of the
    top four closer than TIE_GAP, the largest gap the two runs' drift
    could flip; at most a quarter of the rows may."""
    base = runs["base"]
    got = _rows(base / "port_out" / "beam_pred.csv")
    want = _rows(base / "jax_out" / "beam_pred.csv")
    assert got[0] == want[0] == ["index", "top-1 beam", "top-2 beam",
                                 "top-3 beam"]
    assert len(got) == len(want) == 1 + 4
    differ = [g != w for g, w in zip(got[1:], want[1:])]
    if any(differ):
        top4 = -np.sort(-_jax_test_logits(runs), -1)[:, :4]
        tie = (-np.diff(top4, axis=-1) < TIE_GAP).any(-1)
        assert not any(d and not t for d, t in zip(differ, tie)), (got, want)
        assert sum(differ) <= 1
    for row in got[1:]:
        assert all(1 <= int(b) <= 64 for b in row[1:])
    gc = _rows(base / "port_out" / "beam_pred_confidence_seq.csv")
    wc = _rows(base / "jax_out" / "beam_pred_confidence_seq.csv")
    assert gc[0] == wc[0] == ["", "0"] and len(gc) == len(wc) == 5
    np.testing.assert_allclose([float(r[1]) for r in gc[1:]],
                               [float(r[1]) for r in wc[1:]], rtol=CONF_RTOL)


def test_one_readback_per_epoch(runs):
    eng = runs["port"]
    # train and validate each epoch, test once
    assert eng.readbacks == 2 * EPOCHS + 1
    assert [s["readbacks"] for s in eng.epoch_stats] == [1] * EPOCHS
    assert all(0 <= s["data_wait_share"] <= 1 and s["samples"] == 10
               for s in eng.epoch_stats)


# -- the port alone -----------------------------------------------------------

TINY = dict(SMALL, use_flash_attention=True)


def _batches(n_batches, seed, sizes=(2, 1)):
    cfg = GlobalConfig(**TINY)
    out = []
    for i in range(n_batches):
        b = make_synth_batch(cfg, sizes[i % len(sizes)], seed=seed + i)
        b["scenario"] = np.asarray(["scenario31", "scenario34"][:len(
            b["gps"])] * 2)[:len(b["gps"])]
        out.append(b)
    return out


def _engine(tmp_path, name="run", **kw):
    cfg = GlobalConfig(**TINY)
    model = BeamFuser(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    opts = pengine.TrainOptions(logdir=str(tmp_path / name), epochs=3,
                                scheduler=False, lr=1e-3, **kw)
    return pengine.Engine(model, cfg, opts, device="cpu")


def _weights(eng):
    return {k: v.detach().clone() for k, v in eng.model.state_dict().items()}


def _optim(eng):
    st = eng.state.optimizer.state_dict()["state"]
    return {(i, k): v.clone() for i, s in st.items() for k, v in s.items()}


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=str(k))


def test_save_resume_load_weights_round_trip(tmp_path):
    eng = _engine(tmp_path, ema=True)
    data = _batches(3, seed=5)
    eng.train(data)
    eng.validate(data[:2])
    eng.save()
    ckpt.flush()
    saved, opt, ema = _weights(eng), _optim(eng), dict(eng.state.ema)

    fresh = _engine(tmp_path)                     # the same logdir
    assert fresh.resume()
    assert (fresh.cur_epoch, fresh.cur_iter, fresh.DBA, fresh.train_loss) \
        == (eng.cur_epoch, eng.cur_iter, eng.DBA, eng.train_loss)
    fresh.load_weights("final_model")
    _assert_equal(_weights(fresh), saved)
    # the EMA restarts from the loaded weights
    _assert_equal(fresh.state.ema, dict(fresh.model.named_parameters()))
    ckpt.load_optim(fresh.opts.logdir, "best_optim", fresh.state.optimizer)
    _assert_equal(_optim(fresh), opt)
    best = torch.load(ckpt.model_path(eng.opts.logdir, "best_optim"),
                      weights_only=True)
    _assert_equal(best["ema_params"], {k: v.cpu() for k, v in ema.items()})
    # the saved model keys are the port's flax-scope names
    sd = torch.load(ckpt.model_path(eng.opts.logdir, "final_model"),
                    weights_only=True)
    assert "encoder.image_encoder.stem.conv1.weight" in sd


def test_load_previous_best_rolls_back_weights_not_ema(tmp_path):
    eng = _engine(tmp_path, ema=True, load_previous_best=True,
                  async_save=True)
    data = _batches(2, seed=7)
    eng.train(data)
    eng.DBA.append(0.5)                 # epoch 1 is the best
    eng.save()
    ckpt.flush()
    best, best_opt = _weights(eng), _optim(eng)
    eng.train(data)
    moved = _weights(eng)
    live_ema = {k: v.clone() for k, v in eng.state.ema.items()}
    assert any(not torch.equal(moved[k], best[k]) for k in best)
    eng.DBA.append(0.1)                 # worse: roll back
    eng.save()
    _assert_equal(_weights(eng), best)
    _assert_equal(_optim(eng), best_opt)
    _assert_equal(eng.state.ema, live_ema)
    assert eng.bestval == 0.5 and eng.bestval_epoch == 1


def test_validate_uses_ema_and_test_raw_weights(tmp_path, monkeypatch):
    eng = _engine(tmp_path, ema=True)
    data = _batches(2, seed=9)
    eng.train(data)
    calls = []
    real = torch.func.functional_call

    def spy(model, params, args, kwargs=None):
        calls.append(params)
        return real(model, params, args, kwargs)

    monkeypatch.setattr(torch.func, "functional_call", spy)
    eng.validate(data)
    assert len(calls) == 2 and all(c is eng.state.ema for c in calls)
    calls.clear()
    # test: the raw weights, as the model's own forward
    with torch.no_grad():
        want = [torch.argsort(eng.model.eval()(*(torch.from_numpy(b[k])
                              for k in INPUTS)),
                              dim=-1, descending=True, stable=True)
                for b in data]
    pred = eng.test(data, out_dir=str(tmp_path))
    assert not calls
    np.testing.assert_array_equal(pred, torch.cat(want).numpy())


def test_steps_per_dispatch_matches_single_steps(tmp_path):
    data = _batches(3, seed=11, sizes=(2,))
    ends = []
    for k in (1, 3):
        eng = _engine(tmp_path, name=f"k{k}", steps_per_dispatch=k)
        eng.train(data)
        ends.append(_weights(eng))
    _assert_equal(ends[0], ends[1])


def test_engine_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                       monkeypatch):
    import inspect
    assert inspect.signature(pengine.Engine).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GlobalConfig(**TINY)
    model = BeamFuser(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pengine.Engine(model, cfg, pengine.TrainOptions(
            logdir=str(tmp_path / "x")))
    with pytest.raises(NotImplementedError, match="flatten_accum"):
        pengine.Engine(model, cfg, pengine.TrainOptions(
            logdir=str(tmp_path / "y"), flatten_accum=True), device="cpu")


def test_prefetch_keeps_order_and_surfaces_loader_errors(tmp_path):
    """The loader thread's batches arrive in order; its exception re-raises
    in the training thread; a consumer that leaves early releases the
    thread (joined within a timeout)."""
    import threading
    eng = _engine(tmp_path, prefetch=2)
    rows = [{"image": np.full((1, 2), i, np.float32)} for i in range(40)]
    got = [int(b["image"][0, 0]) for b, _ in eng._prefetched(rows)]
    assert got == list(range(40))

    def failing():
        yield rows[0]
        raise OSError("unreadable frame")

    with pytest.raises(OSError, match="unreadable"):
        list(eng._prefetched(failing()))
    before = set(threading.enumerate())
    it = eng._prefetched(iter(rows))
    next(it)
    it.close()                       # the consumer leaves after one batch
    for t in set(threading.enumerate()) - before:
        t.join(timeout=5)
        assert not t.is_alive()
