"""The port's modality-rebuild subsystem (deepsense6g_tii_tpu_torch/rebuild/,
cli/rebuild.py, cli/rebuild_engine_io.py and the encoder's rebuild hooks)
against the JAX package's, at the small test geometry in f32 on the CPU.

One JAX ``RebuildTrainer`` (the GPT TransFuser, plain attention, dropout 0)
takes two steps from perturbed weights, then rebuilds features and ranks a
third batch; the port's trainer does the same from the same weights (its
flash attention through the kernels' plain versions on the CPU).  JAX's
heads drop with p = 0.5 from bits the port cannot match, so the JAX side
takes a test-local ``RebuildHeads`` whose ``FeatureTrans`` has dropout 0,
set as ``trainer.heads`` before its steps are traced, and the port's
heads run with dropout 0.  The JAX step's gradient is read from AdamW's
first moment after its first step (mu = (1 - b1)·g, b1 = 0.9), and its
program is compiled with XLA's backend optimisation off (the compile
dominates these tests' time).  Tolerances are those of the GPT train step
(tests/test_torch_train.py).
"""

import inspect
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.cli import rebuild as jcli
from deepsense6g_tii_tpu.cli import rebuild_engine_io as jio
from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.rebuild import heads as jheads
from deepsense6g_tii_tpu.rebuild import losses as jlosses
from deepsense6g_tii_tpu.rebuild import trainer as jtrainer
from deepsense6g_tii_tpu_torch.cli import rebuild as cli
from deepsense6g_tii_tpu_torch.cli import rebuild_engine_io as io
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models import fusion
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import (from_jax_variables,
                                                      to_jax_variables)
from deepsense6g_tii_tpu_torch.ops import _build
from deepsense6g_tii_tpu_torch.rebuild import heads, losses
from deepsense6g_tii_tpu_torch.rebuild.trainer import (
    HEAD_KEYS, RebuildOptions, RebuildTrainer, split_encoder_checkpoint)
from deepsense6g_tii_tpu_torch.train import steps
from deepsense6g_tii_tpu_torch.train.state import create_train_state
from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)
from test_torch_train import (FLIP_SHARE, GRAD_RTOL_LEAF, GRAD_RTOL_MODEL,
                              _assert_envelope, _leafmax, _np)

# the GPT TransFuser at the small geometry, image rebuilt from lidar+radar
SMALL = dict(seq_len=2, n_layer=1, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=0, TFM=0,
             embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
             modality_missing="image")
INPUTS = ("image", "lidar", "radar", "gps")
B, LR, ADAM_B1 = 2, 1e-4, 0.9
FUSION_LR = RebuildOptions().fusion_lr


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


class _NoDropHeads(jtrainer.RebuildHeads):
    """JAX's RebuildHeads with the FeatureTrans dropout at 0."""

    @nn.compact
    def __call__(self, feats, source_domain, train: bool = False):
        proj = {m: jheads.ProjectHead(name=f"{m}_projection_l1")(
            f, train=train) for m, f in feats.items()}
        shared = {m: p[..., : p.shape[-1] // 2] for m, p in proj.items()}
        source = jnp.concatenate([shared[m] for m in source_domain], axis=-1)
        s2t = jheads.FeatureTrans(dropout=0.0, name="feat_trans_l1")(
            source, train=train)
        return proj, s2t


def _jax_mu(opt_state, group):
    """AdamW's first moment of one parameter group, as a nested dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        keys = [getattr(k, "key", getattr(k, "name", None)) for k in path]
        if "mu" not in keys or keys[keys.index("mu") + 1] != group:
            continue
        d = out
        for k in keys[keys.index("mu") + 2:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = np.asarray(leaf)
    return out


def _port_trainer(variables, head_vars, device="cpu", **overrides):
    cfg = GlobalConfig(**{**SMALL, "use_flash_attention": True,
                          **overrides})
    model = BeamFuser(cfg, device=device)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    trainer = RebuildTrainer(model, cfg, RebuildOptions(), device=device)
    trainer.heads.feat_trans_l1.p = 0.0
    trainer.heads.load_state_dict(from_jax_variables(head_vars), strict=True)
    trainer.init_state()
    return trainer


def _snapshot(trainer):
    return {n: p.detach().clone() for n, p in
            list(trainer.heads.named_parameters(prefix="heads"))
            + list(trainer.fusion_model.named_parameters(prefix="fusion"))}


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**{**SMALL, "use_flash_attention": False})
    jmodel = JaxBeamFuser(jcfg)
    batches = [make_synth_batch(GlobalConfig(**SMALL), B, seed=50 + i)
               for i in range(3)]
    variables = jax.device_get(randomized(jinit(
        jmodel, *(jnp.asarray(batches[0][k]) for k in INPUTS)), 51))
    trainer = jtrainer.RebuildTrainer(jmodel, jcfg, jtrainer.RebuildOptions())
    trainer.heads = _NoDropHeads()
    state = jax.jit(trainer.init_state)(variables, _jb(batches[0]))
    head_vars = jax.device_get({"params": state.head_params,
                                "batch_stats": state.head_stats})
    return jmodel, trainer, state, batches, variables, head_vars


@pytest.fixture(scope="module")
def trajectory(setup):
    """Two steps of each package from the same weights, the JAX step's
    first gradient, and both packages' rebuilt features and eval ranks on a
    third batch."""
    _, jt, jstate, batches, variables, head_vars = setup
    jstep = jt.train_step.lower(jstate, _jb(batches[0]), LR).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    trainer = _port_trainer(variables, head_vars)
    out = []
    for i, b in enumerate(batches[:2]):
        jstate, jaux = jstep(jstate, _jb(b), LR)
        aux = trainer.train_step(b, LR, floats=True)
        rec = dict(aux=aux, jaux={k: float(v) for k, v in jaux.items()
                                  if k != "head_stats"},
                   port=_snapshot(trainer),
                   jax={**{f"heads.{k}": v for k, v in from_jax_variables(
                       {"params": jstate.head_params}).items()},
                        **{f"fusion.{k}": v for k, v in from_jax_variables(
                            {"params": jstate.fusion_params}).items()}},
                   stats=({n: b_.clone() for n, b_ in
                           trainer.heads.named_buffers()},
                          from_jax_variables({"params": {}, "batch_stats":
                                              jstate.head_stats})))
        if i == 0:
            rec["grads"] = {n: p.grad.clone() for n, p in
                            list(trainer.heads.named_parameters(
                                prefix="heads"))
                            + list(trainer.fusion_model.named_parameters(
                                prefix="fusion"))}
            rec["jax_grads"] = {
                f"{g}.{k}": v / (1 - ADAM_B1) for g, tree in (
                    ("heads", _jax_mu(jstate.opt_state, "heads")),
                    ("fusion", _jax_mu(jstate.opt_state, "fusion")))
                for k, v in from_jax_variables({"params": tree}).items()}
        out.append(rec)
    # rebuild and eval at equal weights: JAX's trained heads and fusion
    # (the frozen copies are the initial weights in both)
    trainer.heads.load_state_dict(from_jax_variables(
        {"params": jstate.head_params, "batch_stats": jstate.head_stats}),
        strict=True)
    trainer.fusion_model.load_state_dict(from_jax_variables(
        {"params": jstate.fusion_params, "batch_stats": jstate.fusion_stats}),
        strict=True)
    third = batches[2]
    rebuilt = (_np(trainer.rebuild_features(third)),
               np.asarray(jt.rebuild_features(jstate, _jb(third))))
    ev = trainer.eval_step(third)
    jev = jt.eval_step(jstate, _jb(third))
    evals = dict(ranks=(_np(ev["ranks"]), np.asarray(jev["ranks"])),
                 loss=(float(ev["loss"]), float(jev["loss"])))
    return out, rebuilt, evals, trainer, jstate


# -- heads and losses -------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("which", ["project", "trans"])
def test_heads_match_flax(which, train):
    """The heads in eval and train mode (dropout off) against flax, with the
    BatchNorm statistics a train-mode call leaves (momentum 0.99)."""
    rng = np.random.default_rng(3)
    c_in = 64 if which == "project" else 128
    x = rng.normal(size=(6, 16, c_in)).astype(np.float32)
    jmod = (jheads.ProjectHead() if which == "project"
            else jheads.FeatureTrans(dropout=0.0))
    variables = randomized(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)),
                           4)
    want, upd = jmod.apply(variables, jnp.asarray(x), train=train,
                           mutable=["batch_stats"])
    port = (heads.ProjectHead() if which == "project"
            else heads.FeatureTrans(dropout=0.0))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    got = port.train(train)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    stats = from_jax_variables({"params": {}, "batch_stats":
                                upd["batch_stats"]})
    for name, buf in port.named_buffers():
        np.testing.assert_allclose(_np(buf), stats[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    # the map back to the JAX tree is the inverse, leaf for leaf
    back = to_jax_variables(port.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(
        jax.device_get(dict(variables, batch_stats=upd["batch_stats"])))


@pytest.mark.parametrize("name", ["contrastive", "distance", "translation"])
def test_losses_match(name):
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(10, 7, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(seq_len=5, temperature=0.1) if name == "contrastive" else {}
    fn = f"{name}_loss"
    want = float(getattr(jlosses, fn)(jnp.asarray(a), jnp.asarray(b), **kw))
    got = getattr(losses, fn)(torch.from_numpy(a), torch.from_numpy(b), **kw)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


# -- the encoder's hooks ------------------------------------------------------

def test_encode_stage1_matches_jax_without_fusion(setup):
    """The port's tap equals JAX's encode_stage1 maps and runs no fusion
    stage: no TokenFusion forward, no kernel launch."""
    jmodel, _, _, batches, variables, _ = setup
    jb = _jb(batches[0])
    _, want = jax.jit(lambda v: jmodel.apply(
        v, *(jb[k] for k in INPUTS), method=jmodel.encode_stage1))(variables)
    model = BeamFuser(GlobalConfig(**SMALL), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    calls = []
    for m in model.modules():
        if isinstance(m, fusion.TokenFusion):
            m.register_forward_pre_hook(lambda *a: calls.append(1))
    x = [torch.from_numpy(batches[0][k]) for k in INPUTS]
    _build.reset_launch_counts()
    got = model.encode_stage1(*x[:3])
    assert calls == [] and _build.KERNEL_LAUNCHES == {}
    for g, w in zip(got, want):
        assert tuple(g.shape) == (B * 2, 16, 16, 64)
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(w)).max())
    model(*x)
    assert len(calls) == 4          # the full forward runs the four stages


def _small_model(target, **overrides):
    cfg = GlobalConfig(**{**SMALL, "modality_missing": target, **overrides})
    return BeamFuser(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(7))


@pytest.mark.parametrize("target", ["image", "lidar", "radar"])
def test_eval_injection_replaces_the_target(target):
    """In eval mode the rebuilt features take the target's stage-1 place:
    the stage-1 maps returned carry them, and the logits equal a forward
    whose target stage1 itself returns them."""
    model = _small_model(target)
    x = [torch.from_numpy(v) for k, v in make_synth_batch(
        model.config, B, seed=8).items() if k in INPUTS]
    rebuild = torch.randn(B * 2, 16, 16, 64,
                          generator=torch.Generator().manual_seed(9))
    enc = model.encoder
    _, maps = enc(*x, rebuild_feats=rebuild, return_stage1=True)
    i = ("image", "lidar", "radar").index(target)
    assert torch.equal(maps[i], rebuild)
    real = enc.encode_stage1(*x[:3])
    for j in {0, 1, 2} - {i}:
        torch.testing.assert_close(maps[j], real[j])
    got = model(*x, rebuild_feats=rebuild)
    stage1 = getattr(enc, f"{target}_encoder").stage1
    stage1.register_forward_hook(lambda *a: rebuild)
    torch.testing.assert_close(got, model(*x), rtol=0, atol=0)


def _drawn(seed):
    return bool(torch.rand((), generator=torch.Generator().manual_seed(
        seed)) < 0.25)


def test_train_mode_injects_a_quarter_of_the_calls():
    """Train mode, image target: one Bernoulli(0.25) draw per call from
    rebuild_generator decides; both branches under fixed generators, and
    the share over many draws.  The lidar target is always injected."""
    model = _small_model("image").train()
    x = [torch.from_numpy(v) for k, v in make_synth_batch(
        model.config, B, seed=10).items() if k in INPUTS]
    rebuild = torch.randn(B * 2, 16, 16, 64,
                          generator=torch.Generator().manual_seed(11))
    seeds = {}
    for s in range(100):
        seeds.setdefault(_drawn(s), s)
    enc = model.encoder
    for use, s in seeds.items():
        _, maps = enc(*x, rebuild_feats=rebuild, return_stage1=True,
                      rebuild_generator=torch.Generator().manual_seed(s))
        assert torch.equal(maps[0], rebuild) == use
    with pytest.raises(ValueError, match="rebuild_generator"):
        enc(*x, rebuild_feats=rebuild)
    g = torch.Generator().manual_seed(12)
    share = np.mean([bool(torch.rand((), generator=g) < 0.25)
                     for _ in range(4000)])
    assert abs(share - 0.25) < 0.025
    lidar = _small_model("lidar").train().encoder
    _, maps = lidar(*x, rebuild_feats=rebuild, return_stage1=True)
    assert torch.equal(maps[1], rebuild)


def test_train_and_eval_steps_take_rebuild_feats():
    """make_train_step and make_eval_step carry a batch's rebuild_feats to
    the model; with grad_accum each microbatch takes its samples' T rows."""
    model = _small_model("lidar")
    batch = make_synth_batch(model.config, 4, seed=13)
    rebuild = np.random.default_rng(14).normal(
        size=(4 * 2, 16, 16, 64)).astype(np.float32)
    state = create_train_state(model)
    ev = steps.make_eval_step(model, model.config, state, device="cpu")
    want = model(*(torch.from_numpy(batch[k]) for k in INPUTS),
                 rebuild_feats=torch.from_numpy(rebuild))
    got = ev({**batch, "rebuild_feats": rebuild})
    torch.testing.assert_close(
        got["ranks"],
        torch.argsort(want, dim=-1, descending=True, stable=True))
    seen = []
    model.encoder.register_forward_pre_hook(
        lambda mod, a, kw: seen.append(kw["rebuild_feats"]), with_kwargs=True)
    step = steps.make_train_step(model, model.config, state, grad_accum=2,
                                 device="cpu")
    assert np.isfinite(float(step({**batch, "rebuild_feats": rebuild},
                                  LR)["loss"]))
    per_sample = torch.from_numpy(rebuild).reshape(4, 2, 16, 16, 64)
    for i, r in enumerate(seen):
        torch.testing.assert_close(r, per_sample[i::2].flatten(0, 1))


# -- the trainer against JAX's ------------------------------------------------

@pytest.mark.parametrize("i", [0, 1])
def test_rebuild_step_losses_match(trajectory, i):
    """Step 0 starts from equal weights; step 1 from weights that step 0's
    AdamW sign flips moved apart."""
    rec = trajectory[0][i]
    for k in ("loss", "trans", "contrast", "distance", "fusion"):
        assert np.isfinite(rec["aux"][k])
        np.testing.assert_allclose(rec["aux"][k], rec["jaux"][k],
                                   rtol=(1e-5, 1e-3)[i], err_msg=k)


def test_rebuild_step_grads_match(trajectory):
    """Heads' and fusion's gradients of the first step, as a whole within
    GRAD_RTOL_MODEL of their norm and leaf by leaf within GRAD_RTOL_LEAF.
    The live image stem and stage1, whose features the rebuilt ones replace,
    and the key biases (softmax ignores a shift shared by all keys) have a
    zero gradient in exact arithmetic: held to 1e-6 of the largest."""
    rec = trajectory[0][0]
    got, want = rec["grads"], rec["jax_grads"]
    assert set(got) == set(want)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum()
                                for g in want.values())))
    diff = float(torch.sqrt(sum(((got[n] - want[n]).double() ** 2).sum()
                                for n in want)))
    assert diff <= GRAD_RTOL_MODEL * norm
    top = max(_leafmax(g) for g in want.values())
    zero = [n for n in want if n.startswith((
        "fusion.encoder.image_encoder.stem.",
        "fusion.encoder.image_encoder.stage1."))]
    assert zero and all(_leafmax(got[n]) == 0.0 for n in zero)
    for n, g in want.items():
        if _leafmax(g) <= 1e-6 * top:
            assert _leafmax(got[n]) <= 1e-6 * top, n
        else:
            assert float((got[n] - g).norm()) <= GRAD_RTOL_LEAF * float(
                g.norm()), n


@pytest.mark.parametrize("i", [0, 1])
def test_rebuild_step_params_and_stats_match(trajectory, i):
    """Parameters within AdamW's sign-flip envelope of their group's lr (the
    heads at LR, the fusion at 1e-6); in step 0 at most FLIP_SHARE of the
    elements moved apart.  The heads' BatchNorm statistics (momentum 0.99)
    within 1e-5 of each leaf's largest value in step 0."""
    rec = trajectory[0][i]
    got, want = rec["port"], rec["jax"]

    def envelope(name, w):
        lr = LR if name.startswith("heads.") else FUSION_LR
        return 2.02 * lr * (i + 1) + 1e-6 * _leafmax(w)

    _assert_envelope(got, want, envelope, "params")
    if i == 0:
        off = sum(int(((got[n] - w).abs() > 0.01 * LR + 1e-6 * _leafmax(w))
                      .sum()) for n, w in want.items())
        assert off <= FLIP_SHARE * sum(w.numel() for w in want.values())
    port_stats, jax_stats = rec["stats"]
    _assert_envelope(port_stats, jax_stats,
                     lambda n, w: (1e-5, 1e-3)[i] * _leafmax(w) + 1e-7,
                     "head batch_stats")


def test_rebuilt_features_and_eval_ranks_match(trajectory):
    """After the two steps, at JAX's trained weights: the rebuilt features
    (heads in eval mode) and the eval step's ranks and focal loss."""
    _, (got, want), evals, _, _ = trajectory
    assert got.shape == want.shape == (B * 2, 16, 16, 64)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    ranks, jranks = evals["ranks"]
    np.testing.assert_array_equal(ranks[:, :3], jranks[:, :3])
    np.testing.assert_allclose(*evals["loss"], rtol=1e-5)


def test_frozen_tap_is_unchanged_by_training(setup, trajectory):
    """The tap runs the stem+stage1 copies taken at init_state: after two
    steps it still gives the initial maps, while the live lidar stem has
    moved."""
    jmodel, _, _, batches, variables, _ = setup
    trainer = trajectory[3]
    init = BeamFuser(GlobalConfig(**SMALL), device="cpu")
    init.load_state_dict(from_jax_variables(variables), strict=True)
    x = [torch.from_numpy(batches[0][k]) for k in INPUTS[:3]]
    want = init.encode_stage1(*x)
    got = trainer._frozen_stage1(trainer.shard(batches[0]))
    for (m, g), w in zip(got.items(), want):
        torch.testing.assert_close(g, w.reshape(g.shape), rtol=0, atol=0)
    live = trainer.fusion_model.encoder.lidar_encoder.stem.conv1.weight
    assert not torch.equal(live, init.encoder.lidar_encoder.stem.conv1.weight)
    assert not any(p.requires_grad for p in trainer.state.frozen.parameters())
    split = split_encoder_checkpoint(init.state_dict())
    trainer.state.frozen[1].load_state_dict(split["lidar_encoder"],
                                            strict=True)


# -- checkpoints -------------------------------------------------------------

def test_save_load_roundtrip(setup, tmp_path):
    _, _, _, batches, variables, head_vars = setup
    a = _port_trainer(variables, head_vars)
    a.train_step(batches[0], LR)
    io.save_rebuild_state(str(tmp_path), a, best=True)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted([f"{p}_{k}.pt" for p in ("best", "final")
                            for k in HEAD_KEYS + ("fusion_model",)]
                           + ["best_optim.pt"])
    b = _port_trainer(variables, head_vars)
    io.load_rebuild_state(str(tmp_path), b, best=True)
    for (n, p), q in zip(a.heads.state_dict().items(),
                         b.heads.state_dict().values()):
        assert torch.equal(p, q), n
    for p, q in zip(a.fusion_model.parameters(), b.fusion_model.parameters()):
        assert torch.equal(p, q)
    assert b.state.optimizer.state_dict()["state"].keys() == \
        a.state.optimizer.state_dict()["state"].keys()
    torch.testing.assert_close(a.rebuild_features(batches[1]),
                               b.rebuild_features(batches[1]), rtol=0,
                               atol=0)


def test_loads_a_jax_logdir(setup, trajectory, tmp_path, capsys):
    """A JAX-written logdir (.msgpack of the same stems) gives the port the
    JAX trainer's rebuilt features."""
    _, jt, _, batches, variables, head_vars = setup
    _, _, _, _, jstate = trajectory
    jio.save_rebuild_state(str(tmp_path), jstate, best=True)
    port = _port_trainer(variables, head_vars)
    io.load_rebuild_state(str(tmp_path), port, best=True)
    assert "starts fresh" in capsys.readouterr().out
    want = np.asarray(jt.rebuild_features(jstate, _jb(batches[2])))
    got = _np(port.rebuild_features(batches[2]))
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# -- the CLI -----------------------------------------------------------------

SMALL_FLAGS = ["--seq_len", "2", "--compute_dtype", "float32",
               "--input_resolution", "64", "--vert_anchors", "2",
               "--horz_anchors", "2", "--n_layer", "1",
               "--backbone_blocks", "1,1,1,1", "--num_workers", "2",
               "--batch_size", "4"]
REQUIRED = ["-s", "lidar", "radar", "-t", "image"]


def test_every_jax_flag_parses_with_equal_defaults():
    want = vars(jcli.build_parser().parse_args(REQUIRED + ["--id", "x"]))
    got = vars(cli.build_parser().parse_args(REQUIRED + ["--id", "x"]))
    assert set(got) == set(want)
    for key in want:
        assert got[key] == (want[key] if key != "device" else "cuda"), key
    assert want["device"] == "tpu"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch,
                                                          tmp_path):
    assert cli.build_parser().get_default("device") == "cuda"
    assert inspect.signature(RebuildTrainer).parameters[
        "device"].default == "cuda"
    model = _small_model("image")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(REQUIRED + ["--logdir", str(tmp_path / "r")])
    assert not os.path.exists(tmp_path / "r")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RebuildTrainer(model, model.config, RebuildOptions())


def test_trainer_requires_the_target_missing():
    with pytest.raises(ValueError, match="modality_missing"):
        RebuildTrainer(_small_model("lidar"), GlobalConfig(
            **{**SMALL, "modality_missing": "lidar"}), RebuildOptions(),
            device="cpu")


def test_main_trains_then_validates(tmp_path, capsys):
    """One epoch on a demo tree from a port .pt fusion checkpoint, then
    --Val 1 with --load_model_dir on its logdir."""
    root = make_demo_root(str(tmp_path / "data"), n_train=3, n_adapt=2,
                          n_test=1, seq_len=2)
    # the CLI's model: the MambaFuser of the config's defaults
    fuser = BeamFuser(GlobalConfig(**{k: v for k, v in SMALL.items()
                                      if k not in ("FFM", "TFM")}),
                      device="cpu")
    torch.save(fuser.state_dict(), str(tmp_path / "fuser.pt"))
    logdir = str(tmp_path / "run")
    base = REQUIRED + ["--device", "cpu", "--data_root", root,
                       "--fusion_model_path", str(tmp_path / "fuser.pt"),
                       *SMALL_FLAGS]
    assert cli.main(base + ["--logdir", logdir, "--epochs", "1"]) == 0
    names = set(os.listdir(logdir))
    for prefix in ("best", "final"):
        for key in HEAD_KEYS + ("fusion_model",):
            assert f"{prefix}_{key}.pt" in names
    assert "best_optim.pt" in names
    rec = json.load(open(os.path.join(logdir, "recent.log")))
    assert rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all()
    tags = {json.loads(line)["tag"]
            for line in open(os.path.join(logdir, "scalars.jsonl"))}
    assert tags == {"curr_iter_loss_trans", "curr_iter_loss_contrast",
                    "curr_iter_loss_distance", "curr_iter_loss_fusion",
                    "curr_loss_train", "DBA_score_val/scenario_all",
                    "curr_loss_val"}
    capsys.readouterr()
    assert cli.main(base + ["--logdir", str(tmp_path / "val"), "--Val", "1",
                            "--load_model_dir", logdir]) == 0
    out = capsys.readouterr().out
    dba = float(out.split("Val DBA:")[1].split()[0])
    assert 0.0 <= dba <= 1.0 and "Val finish" in out
