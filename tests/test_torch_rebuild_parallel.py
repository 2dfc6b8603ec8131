"""Data-parallel modality-rebuild training in the port
(``RebuildTrainer(mesh=...)``, ``parallel/distributed.py::all_gather_rows``,
the heads' global BatchNorm, ``cli/rebuild.py`` under
``torch.distributed.run``) on the CPU with gloo, against JAX's
``RebuildTrainer(mesh=make_mesh(2))`` on the global batch.

Two ranks hold two rows each of a global batch of four, at
``tests/test_torch_rebuild.py``'s geometry (the GPT TransFuser, f32,
dropout 0, its dropout-0 JAX heads) and with that file's tolerances.  Rank
workers are this file run as a script: they import the port only, read
their inputs from an ``.npz`` and write their results to one.  Every
subprocess has a timeout, after which it and its peers are killed
(``tests/test_torch_parallel.py::_Processes``).  The JAX oracle runs in the
test process while they do.  Also here: the port's own ``FeatureTrans``
dropout at p = 0.5, whose bits JAX's cannot match.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

WORLD, B, LR = 2, 4, 1e-4       # ranks, global batch, the heads' lr

if __name__ != "__main__":
    # the test process: the JAX oracle and test_torch_rebuild's tolerances
    import jax
    import jax.numpy as jnp

    from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
    from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
    from deepsense6g_tii_tpu.parallel import mesh as jmesh
    from deepsense6g_tii_tpu.rebuild import heads as jheads
    from deepsense6g_tii_tpu.rebuild import trainer as jtrainer
    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
    from deepsense6g_tii_tpu_torch.parallel.mesh import Mesh
    from deepsense6g_tii_tpu_torch.rebuild import heads
    from deepsense6g_tii_tpu_torch.rebuild.trainer import (RebuildOptions,
                                                          RebuildTrainer)
    from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
    from synthetic_data import jinit
    from test_torch_modules import randomized
    from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)
    from test_torch_parallel import _free_port, _Processes
    from test_torch_rebuild import (ADAM_B1, FUSION_LR, INPUTS, REQUIRED,
                                    SMALL, SMALL_FLAGS, _jax_mu,
                                    _NoDropHeads, _small_model)
    from test_torch_train import (FLIP_SHARE, GRAD_RTOL_MODEL,
                                  _assert_envelope, _leafmax)

LOSSES = ("loss", "trans", "contrast", "distance", "fusion")


# -- the subprocesses, started before the JAX oracle runs ---------------------

@pytest.fixture(scope="module")
def oracle_inputs():
    """JAX's initial fusion variables and heads, the three global batches,
    and the BatchNorm case's head variables and input."""
    jcfg = JaxConfig(**{**SMALL, "use_flash_attention": False})
    jmodel = JaxBeamFuser(jcfg)
    batches = [make_synth_batch(GlobalConfig(**SMALL), B, seed=60 + i)
               for i in range(3)]
    variables = jax.device_get(randomized(jinit(
        jmodel, *(jnp.asarray(batches[0][k]) for k in INPUTS)), 61))
    trainer = jtrainer.RebuildTrainer(jmodel, jcfg, jtrainer.RebuildOptions(),
                                      mesh=jmesh.make_mesh(WORLD))
    trainer.heads = _NoDropHeads()
    state = jax.jit(trainer.init_state)(variables, trainer.shard(batches[0]))
    head_vars = jax.device_get({"params": state.head_params,
                                "batch_stats": state.head_stats})
    rng = np.random.default_rng(62)
    bn_x = (rng.normal(size=(2 * B, 16, 64)) * 2 + 0.5).astype(np.float32)
    bn_vars = jax.device_get(randomized(jheads.ProjectHead().init(
        jax.random.PRNGKey(1), jnp.asarray(bn_x)), 63))
    return dict(trainer=trainer, state=state, batches=batches,
                variables=variables, head_vars=head_vars, bn_x=bn_x,
                bn_vars=bn_vars)


@pytest.fixture(scope="module")
def started(oracle_inputs, tmp_path_factory):
    """Starts, without waiting for them:

    * ``ranks``: this file's worker as ranks 0 and 1 of a gloo group, on
      the weights and batches of :func:`oracle_inputs`;
    * ``cli``: ``torch.distributed.run --nproc_per_node 2 -m ...cli.rebuild``,
      one epoch on a demo tree at global batch 4 (2 a rank), the default
      ``log/<id>`` logdir (each process's own clock in ``<id>``: the
      broadcast pins rank 0's)."""
    o = oracle_inputs
    r = tmp_path_factory.mktemp("rebuild_ranks")
    inputs = {f"w/{k}": v.numpy()
              for k, v in from_jax_variables(o["variables"]).items()}
    inputs.update({f"h/{k}": v.numpy()
                   for k, v in from_jax_variables(o["head_vars"]).items()})
    inputs.update({f"bn/{k}": v.numpy()
                   for k, v in from_jax_variables(o["bn_vars"]).items()})
    inputs["bn_x"] = o["bn_x"]
    inputs.update({f"b{i}/{k}": v for i, b in enumerate(o["batches"])
                   for k, v in b.items() if k != "scenario"})
    inputs["config"] = np.asarray(json.dumps(SMALL))
    np.savez(r / "in.npz", **inputs)
    port = _free_port()
    ranks = _Processes(
        [[sys.executable, os.path.abspath(__file__), str(r / "in.npz"),
          str(rank), str(port), str(r / f"out{rank}.npz")]
         for rank in range(WORLD)], str(r))
    d = tmp_path_factory.mktemp("rebuild_cli")
    root = make_demo_root(str(d / "data"), n_train=3, n_adapt=2, n_test=1,
                          seq_len=2)
    os.makedirs(d / "run")
    cli = _Processes([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", str(WORLD), "--tee", "3",
        "-m", "deepsense6g_tii_tpu_torch.cli.rebuild", *REQUIRED,
        "--device", "cpu", "--data_root", root, "--epochs", "1",
        *SMALL_FLAGS]], str(d), cwd=str(d / "run"))
    yield {"ranks": (r, ranks), "cli": (d, cli)}
    for group in (ranks, cli):
        group.kill()
    for folder in (r, d):
        shutil.rmtree(folder, ignore_errors=True)


# -- JAX's steps over its mesh, and the ranks' --------------------------------

def _named_params(tree, prefix):
    return {f"{prefix}.{k}": v for k, v in from_jax_variables(
        {"params": tree}).items()}


@pytest.fixture(scope="module")
def jax_trajectory(oracle_inputs, started):
    """JAX's two steps on the global batches over a 2-device mesh (its
    program compiled with XLA's backend optimisation off, as in
    tests/test_torch_rebuild.py), its first gradient (from AdamW's first
    moment) and its eval ranks and loss on the third batch."""
    o = oracle_inputs
    jt, jstate = o["trainer"], o["state"]
    jstep = jt.train_step.lower(jstate, jt.shard(o["batches"][0]), LR).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    out = []
    for i, b in enumerate(o["batches"][:2]):
        jstate, jaux = jstep(jstate, jt.shard(b), LR)
        rec = dict(aux={k: float(jaux[k]) for k in LOSSES},
                   params={**_named_params(jstate.head_params, "heads"),
                           **_named_params(jstate.fusion_params, "fusion")},
                   stats=from_jax_variables({"params": {}, "batch_stats":
                                             jstate.head_stats}))
        if i == 0:
            rec["grads"] = {
                f"{g}.{k}": v / (1 - ADAM_B1) for g in ("heads", "fusion")
                for k, v in from_jax_variables({"params": _jax_mu(
                    jstate.opt_state, g)}).items()}
        out.append(rec)
    ev = jt.eval_step(jstate, jt.shard(o["batches"][2]))
    return out, (np.asarray(ev["ranks"]), float(ev["loss"]))


@pytest.fixture(scope="module")
def ranks(started, jax_trajectory):
    """The ranks' results, awaited after JAX's steps (which run while the
    ranks do)."""
    d, procs = started["ranks"]
    procs.wait()
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(WORLD)]
    shutil.rmtree(d)
    return outs


def _kind(out, prefix):
    return {k[len(prefix):]: torch.from_numpy(v) for k, v in out.items()
            if k.startswith(prefix)}


# -- all_gather_rows ----------------------------------------------------------

def test_all_gather_rows_forward(ranks):
    """Every rank holds both ranks' rows in rank order, bit for bit."""
    x = _gather_input()
    for out in ranks:
        np.testing.assert_array_equal(out["gather/out"], x)


def test_all_gather_rows_gradient_is_the_concatenations(ranks):
    """Each rank's loss reads the gathered rows (a coupling function of
    all of them, divided by the ranks); the gradient a rank's rows get
    equals one process's through ``torch.cat`` of the same rows."""
    x = torch.from_numpy(_gather_input()).requires_grad_()
    _gather_loss(torch.cat(list(x.split(len(x) // WORLD)))).backward()
    got = np.concatenate([out["gather/grad"] for out in ranks])
    np.testing.assert_allclose(got, x.grad.numpy(), rtol=1e-5,
                               atol=1e-6 * float(x.grad.abs().max()))


def test_unequal_row_counts_raise_on_every_rank(ranks):
    for out in ranks:
        assert "unequal row counts [2, 3]" in str(out["gather/unequal"])


# -- the heads' BatchNorm over the group --------------------------------------

def test_head_batchnorm_is_global_as_flax(oracle_inputs, ranks):
    """A ProjectHead in train mode, its BatchNorms over the group: the
    ranks' rows of the output, the running statistics and the summed
    gradients of the weights are flax's on the global batch."""
    o = oracle_inputs
    x, cot = o["bn_x"], _bn_cotangent(len(o["bn_x"]))
    jmod = jheads.ProjectHead()

    def f(params):
        y, upd = jmod.apply({"params": params,
                             "batch_stats": o["bn_vars"]["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd["batch_stats"])

    (_, (want, stats)), grads = jax.value_and_grad(f, has_aux=True)(
        o["bn_vars"]["params"])
    got = np.concatenate([out["bn/out"] for out in ranks])
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    want_stats = from_jax_variables({"params": {}, "batch_stats": stats})
    want_grads = from_jax_variables({"params": grads})
    # the biases before a BatchNorm have no gradient in exact arithmetic:
    # rounding noise, held to 1e-5 of the largest |g| as every leaf is
    top = max(_leafmax(w) for w in want_grads.values())
    for out in ranks:
        for name, w in want_stats.items():
            np.testing.assert_allclose(out[f"bn/stats/{name}"], w.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
        for name, w in want_grads.items():
            np.testing.assert_allclose(out[f"bn/grads/{name}"], w.numpy(),
                                       rtol=1e-4, atol=1e-5 * top,
                                       err_msg=name)


# -- two steps against JAX's over its mesh ------------------------------------

@pytest.mark.parametrize("i", [0, 1])
def test_two_rank_losses_match_jax(jax_trajectory, ranks, i):
    """Every rank reports the global batch's five losses: JAX's, to
    test_torch_rebuild.py's tolerances (step 1 starts from weights that
    step 0's AdamW sign flips moved apart)."""
    want = jax_trajectory[0][i]["aux"]
    for out in ranks:
        for k, v in zip(LOSSES, out[f"{i}/aux"]):
            assert np.isfinite(v)
            np.testing.assert_allclose(v, want[k], rtol=(1e-5, 1e-3)[i],
                                       err_msg=k)


@pytest.mark.parametrize("i", [0, 1])
def test_two_rank_params_and_head_stats_match_jax(jax_trajectory, ranks, i):
    """Parameters within AdamW's sign-flip envelope of their group's lr
    (at most FLIP_SHARE of the elements apart in step 0); the heads'
    BatchNorm statistics over both ranks' rows within (1e-5, 1e-3) of a
    leaf's largest value."""
    rec = jax_trajectory[0][i]
    got, want = _kind(ranks[0], f"{i}/params/"), rec["params"]

    def envelope(name, w):
        lr = LR if name.startswith("heads.") else FUSION_LR
        return 2.02 * lr * (i + 1) + 1e-6 * _leafmax(w)

    _assert_envelope(got, want, envelope, "params")
    if i == 0:
        off = sum(int(((got[n] - w).abs() > 0.01 * LR + 1e-6 * _leafmax(w))
                      .sum()) for n, w in want.items())
        assert off <= FLIP_SHARE * sum(w.numel() for w in want.values())
    _assert_envelope(_kind(ranks[0], f"{i}/stats/"), rec["stats"],
                     lambda n, w: (1e-5, 1e-3)[i] * _leafmax(w) + 1e-7,
                     "head batch_stats")


def _global_gap(got, want):
    num = float(torch.sqrt(sum(((got[n] - w).double() ** 2).sum()
                               for n, w in want.items())))
    den = float(torch.sqrt(sum((w.double() ** 2).sum()
                               for w in want.values())))
    return num, den


def test_two_rank_gradient_matches_jax(jax_trajectory, ranks):
    """The first step's summed gradient (heads and fusion model) within
    GRAD_RTOL_MODEL of the norm of JAX's over its mesh."""
    num, den = _global_gap(_kind(ranks[0], "0/grads/"),
                           jax_trajectory[0][0]["grads"])
    assert den > 0 and num <= GRAD_RTOL_MODEL * den, num / den


def test_two_rank_gradient_is_the_global_batch_gradient(ranks):
    """The ranks' summed gradient of step 0 against one process's
    RebuildTrainer on the whole global batch from the same weights, to the
    norm bound of test_torch_train.py: only the order of BatchNorm's and
    the losses' sums differs.  An average in place of the sum, or NT-Xent
    over a rank's own rows, would be far off."""
    for out in ranks:
        num, den = _global_gap(_kind(out, "0/grads/"),
                               _kind(ranks[0], "one/grads/"))
        assert den > 0 and num <= GRAD_RTOL_MODEL * den, num / den
    np.testing.assert_allclose(ranks[0]["0/aux"], ranks[0]["one/aux"],
                               rtol=1e-5)


def test_local_only_contrastive_term_is_detectably_different(
        jax_trajectory, ranks):
    """NT-Xent over a rank's own rows (a port without the gather) lies
    outside the loss tolerance of the gathered term, on every rank."""
    want = jax_trajectory[0][0]["aux"]["contrast"]
    for out in ranks:
        got = float(out["0/aux"][LOSSES.index("contrast")])
        local = float(out["0/local_contrast"])
        np.testing.assert_allclose(got, want, rtol=1e-5)
        assert abs(local - want) > 100 * 1e-5 * abs(want), (local, want)


def test_ranks_stay_bit_equal(ranks):
    """After every step the heads, the fusion model, the heads' statistics
    and AdamW's state are the same bits on both ranks (rank 1 started from
    other weights: init_state's broadcast replaced them), and so are the
    losses: their sha256 digests agree."""
    da, db = (json.loads(str(out["digests"])) for out in ranks)
    assert set(da) == set(db) and len(da) > 100
    assert [k for k in da if da[k] != db[k]] == []


def test_eval_ranks_match_jax(jax_trajectory, ranks):
    """After the two steps, every rank's eval step on the third batch (no
    collective: running statistics) gives JAX's top-3 beams and focal
    loss."""
    jranks, jloss = jax_trajectory[1]
    for out in ranks:
        np.testing.assert_array_equal(out["eval/ranks"][:, :3],
                                      jranks[:, :3])
        np.testing.assert_allclose(float(out["eval/loss"]), jloss,
                                   rtol=1e-3)


def test_trainer_refuses_a_serving_mesh():
    model = _small_model("image")
    with pytest.raises(ValueError, match="serving mesh"):
        RebuildTrainer(model, model.config, RebuildOptions(), device="cpu",
                       mesh=Mesh(["cpu", "cpu"]))


# -- the rebuild CLI over two processes ---------------------------------------

@pytest.fixture(scope="module")
def rebuild_cli(started):
    """The run's logdirs, the files of each and the rank-prefixed lines of
    each rank's output; the run's directory is removed."""
    d, procs = started["cli"]
    (out,) = procs.wait()
    lines = [[line.split(":", 1)[1] for line in out.splitlines()
              if line.startswith(f"[default{r}]:")] for r in range(WORLD)]
    log = d / "run" / "log"
    runs = {run: {f: (open(log / run / f).read() if f.endswith(
        (".log", ".txt", ".jsonl")) else None)
        for f in os.listdir(log / run)} for run in os.listdir(log)}
    shutil.rmtree(d)
    return runs, lines


def test_rebuild_cli_one_logdir(rebuild_cli):
    """Both ranks trained and validated into one logdir, which holds the
    5-way best and final files."""
    runs, lines = rebuild_cli
    (files,) = runs.values()
    rec = json.loads(files["recent.log"])
    assert rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all()
    for prefix in ("best", "final"):
        for key in ("image_projection_l1", "lidar_projection_l1",
                    "radar_projection_l1", "feat_trans_l1", "fusion_model"):
            assert f"{prefix}_{key}.pt" in files
    assert "best_optim.pt" in files
    for r, out in enumerate(lines):
        info = [x for x in out if x.startswith("distributed:")]
        assert info and f"'process_index': {r}" in info[0]
        assert "'process_count': 2" in info[0]


def test_rebuild_cli_rank0_writes_only(rebuild_cli):
    """One scalar stream and one event file: rank 1 logged nothing, and
    wrote no file of its own."""
    runs, _ = rebuild_cli
    (files,) = runs.values()
    assert len([f for f in files if f.startswith("events.out")]) == 1
    assert not [f for f in files if f.endswith(".tmp")]
    tags = [json.loads(x)["tag"] for x in files["scalars.jsonl"].splitlines()]
    assert tags.count("curr_loss_train") == 1
    assert tags.count("DBA_score_val/scenario_all") == 1
    assert json.loads(files["args.txt"])["batch_size"] == B


def test_rebuild_cli_dba_agrees(rebuild_cli):
    """The validation DBA (the full split on each rank) is the same on both
    ranks, and so are the epoch's per-step losses (the global batch's)."""
    _, lines = rebuild_cli
    picked = [[x for x in out if "DBA" in x] for out in lines]
    assert any("Val DBA:" in x for x in picked[0]) and picked[0] == picked[1]


# -- the heads' dropout -------------------------------------------------------

def test_feature_trans_dropout_rate_and_scale():
    """The port's FeatureTrans in train mode at p = 0.5 (JAX draws other
    bits, so tests/test_torch_rebuild.py holds the heads at p = 0): against
    the same call at p = 0, each element of fc3's input is kept or zeroed,
    the kept ones scaled by exactly 1/(1 - p), and the kept share of n =
    65,536 elements lies within 5 binomial standard deviations
    (5·sqrt(p(1-p)/n) = 0.0098) of 1 - p at a fixed seed."""
    ft = heads.FeatureTrans().train()
    assert ft.p == 0.5
    x = torch.randn(32, 16, 128, generator=torch.Generator().manual_seed(1))
    seen = {}
    ft.fc3.register_forward_pre_hook(lambda m, a: seen.update(x=a[0]))
    ft(x, torch.Generator().manual_seed(2))
    dropped = seen["x"]
    ft.p = 0.0
    ft(x)
    clean = seen["x"]
    assert clean.numel() == 65536 and bool((clean != 0).all())
    kept = dropped != 0
    share = float(kept.float().mean())
    assert abs(share - 0.5) <= 5 * (0.25 / clean.numel()) ** 0.5, share
    assert torch.equal(dropped[kept], clean[kept] / (1.0 - 0.5))
    ft.p = 0.5
    with pytest.raises(ValueError, match="generator"):
        ft(x)


# -- inputs shared by the worker and the tests --------------------------------

def _gather_input():
    return np.random.default_rng(70).normal(size=(2 * WORLD, 6)).astype(
        np.float32)


def _gather_loss(g):
    """A function of the gathered rows that couples all of them."""
    return torch.logsumexp((g @ g.T).flatten(), 0) + (g.sin() ** 2).sum()


def _bn_cotangent(n):
    """The weights of the ProjectHead case's (n, 16, 128) output."""
    return np.random.default_rng(71).normal(size=(n, 16, 128)).astype(
        np.float32)


# -- the rank worker ----------------------------------------------------------

def _worker(npz, rank, port, out):
    """This rank's cases in a 2-rank gloo group; writes to ``out``
    everything the tests compare."""
    torch.set_num_threads(2)
    import hashlib

    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.parallel.mesh import (make_mesh,
                                                         sync_batchnorm)
    from deepsense6g_tii_tpu_torch.rebuild import heads
    from deepsense6g_tii_tpu_torch.rebuild import trainer as rtrainer

    rank = int(rank)
    distributed.initialize(f"127.0.0.1:{port}", WORLD, rank, require=True)
    mesh = make_mesh()
    group = mesh.group
    inp = np.load(npz)
    res = {}

    def entries(prefix):
        return {k[len(prefix):]: torch.from_numpy(inp[k]) for k in inp.files
                if k.startswith(prefix)}

    # all_gather_rows: forward, gradient, unequal counts
    x = torch.from_numpy(_gather_input())[mesh.rows(2 * WORLD)]
    x.requires_grad_()
    g = distributed.all_gather_rows(x, group)
    (_gather_loss(g) / WORLD).backward()
    res["gather/out"] = g.detach().numpy()
    res["gather/grad"] = x.grad.numpy()
    try:
        distributed.all_gather_rows(torch.zeros(2 + rank, 3), group)
        res["gather/unequal"] = np.asarray("no error")
    except ValueError as e:
        res["gather/unequal"] = np.asarray(str(e))

    # a ProjectHead with its BatchNorms over the group
    head = heads.ProjectHead()
    head.load_state_dict(entries("bn/"), strict=True)
    sync_batchnorm(head, mesh)
    bx = torch.from_numpy(inp["bn_x"])
    rows = mesh.rows(len(bx))
    y = head.train()(bx[rows])
    (y * torch.from_numpy(_bn_cotangent(len(bx)))[rows]).sum().backward()
    res["bn/out"] = y.detach().numpy()
    grads = [p.grad for p in head.parameters()]
    flat = torch.cat([t.reshape(-1) for t in grads])
    torch.distributed.all_reduce(flat, group=group)
    for (n, p), v in zip(head.named_parameters(),
                         flat.split([t.numel() for t in grads])):
        res[f"bn/grads/{n}"] = v.view_as(p).numpy()
    for n, b in head.named_buffers():
        res[f"bn/stats/{n}"] = b.numpy()

    # the trainer: two steps on this rank's rows, then an eval step
    small = json.loads(str(inp["config"]))
    small["backbone_blocks"] = tuple(small["backbone_blocks"])
    cfg = GlobalConfig(**{**small, "use_flash_attention": True})
    batches = [{k.split("/", 1)[1]: inp[k] for k in inp.files
                if k.startswith(f"b{i}/")} for i in range(3)]

    def make_trainer(weights, head_weights, m):
        model = BeamFuser(cfg, device="cpu")
        model.load_state_dict(weights, strict=True)
        tr = rtrainer.RebuildTrainer(model, cfg, rtrainer.RebuildOptions(),
                                     device="cpu", mesh=m)
        tr.heads.feat_trans_l1.p = 0.0
        tr.heads.load_state_dict(head_weights, strict=True)
        tr.init_state()
        return tr

    weights, head_weights = entries("w/"), entries("h/")
    if rank:        # other weights: init_state's broadcast replaces them
        weights, head_weights = (
            {k: v + 0.01 if v.is_floating_point() else v
             for k, v in d.items()} for d in (weights, head_weights))
    trainer = make_trainer(weights, head_weights, mesh)
    assert trainer.group is group

    # the contrastive terms, also as a port without the gather has them
    real, local = rtrainer.contrastive_loss, []

    def recording(x1, x2, seq_len, temperature, group=None):
        local.append(float(real(x1.detach(), x2.detach(), seq_len,
                                temperature=temperature)))
        return real(x1, x2, seq_len, temperature=temperature, group=group)

    rtrainer.contrastive_loss = recording
    digests = {}

    def keep(key, tensor, values=True):
        a = tensor.detach().numpy()
        digests[key] = hashlib.sha256(a.tobytes()).hexdigest()
        if values and rank == 0:
            res[key] = a.copy()

    named = (list(trainer.heads.named_parameters(prefix="heads"))
             + list(trainer.fusion_model.named_parameters(prefix="fusion")))
    for i in range(2):
        b = batches[i]
        aux = trainer.train_step({k: v[mesh.rows(B)] for k, v in b.items()},
                                 LR, floats=True)
        res[f"{i}/aux"] = np.asarray([aux[k] for k in LOSSES])
        if i == 0:
            res["0/local_contrast"] = np.asarray(sum(local[-3:]) / 3.0)
            for n, p in named:
                res[f"0/grads/{n}"] = p.grad.numpy().copy()
        keep(f"{i}/aux", torch.from_numpy(res[f"{i}/aux"]))
        for n, p in named:
            keep(f"{i}/params/{n}", p)
        for n, t in trainer.heads.named_buffers():
            keep(f"{i}/stats/{n}", t)
        for n, t in trainer.fusion_model.named_buffers():
            keep(f"{i}/fusion_buffers/{n}", t, values=False)
        for j, s in enumerate(trainer.state.optimizer.state.values()):
            for n, t in s.items():
                keep(f"{i}/adam/{j}/{n}", t, values=False)
    rtrainer.contrastive_loss = real
    ev = trainer.eval_step(batches[2])
    res["eval/ranks"] = ev["ranks"].numpy()
    res["eval/loss"] = ev["loss"].numpy()

    # one process on the whole global batch from the initial weights
    one = make_trainer(entries("w/"), entries("h/"), None)
    aux = one.train_step(batches[0], LR, floats=True)
    res["one/aux"] = np.asarray([aux[k] for k in LOSSES])
    for n, p in (list(one.heads.named_parameters(prefix="heads"))
                 + list(one.fusion_model.named_parameters(prefix="fusion"))):
        res[f"one/grads/{n}"] = p.grad.numpy().copy()
    res["digests"] = np.asarray(json.dumps(digests))
    distributed.barrier("written")
    np.savez(out, **res)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
