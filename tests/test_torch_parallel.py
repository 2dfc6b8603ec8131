"""The port's data parallelism (deepsense6g_tii_tpu_torch/parallel/) on the
CPU with gloo: masked, global-batch BatchNorm against flax's
``BatchNorm(mask=...)``; the ``valid`` row mask's step against JAX
``make_train_step`` with ``valid`` and against the unpadded step; a 2-rank
``make_train_step`` against JAX's step on the global batch; the process
group's set-up, ``shard_for_process`` against the JAX package's, a
2-process ``cli.train --multihost 1`` epoch under ``torch.distributed.run``,
and ``Predictor(use_mesh=...)`` over two CPU devices.

Rank workers are this file run as a script: they import the port only,
read their inputs from an ``.npz`` and write their results to one.  Every
subprocess has a timeout, after which it and its peers are killed.  The
JAX oracle runs in the test process at ``tests/test_torch_train.py``'s
geometry, batch and step options, and so with its tolerances.
"""

import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 240          # seconds, for a whole group of processes
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "DEEPSENSE_COORDINATOR",
                "DEEPSENSE_NUM_PROCESSES", "DEEPSENSE_PROCESS_ID")

if __name__ != "__main__":
    # the test process: the JAX oracle and test_torch_train's tolerances
    import jax
    import jax.numpy as jnp

    from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
    from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
    from deepsense6g_tii_tpu.train import state as jax_state
    from deepsense6g_tii_tpu.train import steps as jax_steps
    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.models import resnet
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.parallel.mesh import Mesh, pad_batch
    from deepsense6g_tii_tpu_torch.train import steps
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
    from synthetic_data import jinit
    from test_torch_cli import SMALL_FLAGS
    from test_torch_modules import randomized
    from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)
    from test_torch_train import (B, CLIP, GRAD_RTOL_MODEL, INPUTS, LR,
                                  SMALL, _assert_envelope, _batches, _copy,
                                  _ema_envelope, _jax_snapshot, _np,
                                  _params_envelope, _port_model, _snapshot,
                                  _stats_tol)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Processes:
    """Subprocesses started together, each writing to its own log file;
    :meth:`wait` returns their logs, and kills all of them (their process
    groups) if one fails or the time runs out."""

    def __init__(self, cmds, logdir, cwd=REPO):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
        env["PYTHONPATH"] = os.pathsep.join(
            x for x in (REPO, os.environ.get("PYTHONPATH")) if x)
        self.logs = [os.path.join(logdir, f"proc{i}.log")
                     for i in range(len(cmds))]
        self.procs = []
        for cmd, log in zip(cmds, self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    cmd, stdout=f, stderr=subprocess.STDOUT, env=env,
                    cwd=cwd, start_new_session=True))
        self.deadline = time.monotonic() + WORKER_TIMEOUT

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()

    def wait(self):
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs):
                    break           # one failed: its peers would hang
                if time.monotonic() > self.deadline:
                    break
                time.sleep(0.1)
        finally:
            self.kill()
        outs = [open(log).read() for log in self.logs]
        for p, out in zip(self.procs, outs):
            assert p.returncode == 0, f"exit {p.returncode}:\n{out[-4000:]}"
        return outs


# -- masked, global BatchNorm --------------------------------------------------

@pytest.mark.parametrize("sample_mask", [(1, 1, 0), (0, 1, 0), (1, 0, 1)])
def test_masked_batchnorm_matches_flax(sample_mask):
    """Output, running statistics and the gradients of the output, the
    scale and the bias, at 3 samples of 2 frames."""
    import flax.linen as nn
    from deepsense6g_tii_tpu.models.resnet import bn_sample_mask
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(6, 5, 4, 8)) * 3 + 1).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale, bias = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    sm = np.asarray(sample_mask, np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    jmask = bn_sample_mask(jnp.asarray(sm), 2)

    def f(params, x):
        y, upd = bn.apply({"params": params,
                           "batch_stats": {"mean": mean, "var": var}},
                          x, mask=jmask, mutable=["batch_stats"])
        return (y * cot).sum(), (y, upd["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            jnp.asarray(x))
    port = resnet.BatchNorm(8).train()
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean),
                          "running_var": torch.from_numpy(var)})
    xt = torch.from_numpy(x).requires_grad_()
    got = port(xt, resnet.bn_sample_mask(torch.from_numpy(sm), 2))
    (got * torch.from_numpy(cot)).sum().backward()
    for a, b, what in ((got, want, "output"), (xt.grad, gx, "dx"),
                       (port.weight.grad, gp["scale"], "dscale"),
                       (port.bias.grad, gp["bias"], "dbias")):
        b = np.asarray(b)
        np.testing.assert_allclose(_np(a), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(), err_msg=what)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(_np(getattr(port, name)),
                                   np.asarray(stats[key]), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


# -- the subprocesses, started before the JAX oracle runs ----------------------

@pytest.fixture(scope="module")
def started(request, tmp_path_factory):
    """Starts, without waiting for them:

    * ``cli``: ``torch.distributed.run --nproc_per_node 2 -m ...cli.train
      --multihost 1``, one epoch on a demo tree (10 training samples, 5 a
      rank), global batch 4 (2 a rank).  The logdir is the default
      ``log/<id>`` with each process's own clock in ``<id>``: the
      broadcast pins rank 0's (JAX ``tests/test_multiprocess.py:138``);
    * ``ranks``: this file's worker as ranks 0 and 1 of a gloo group, on
      the weights and batches of :func:`setup`."""
    d = tmp_path_factory.mktemp("multihost")
    root = make_demo_root(str(d / "data"), n_train=3, n_adapt=3, n_test=2,
                          seq_len=2)
    os.makedirs(d / "run")
    cli = _Processes([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc_per_node", "2", "--tee", "3",
        "-m", "deepsense6g_tii_tpu_torch.cli.train", "--multihost", "1",
        "--device", "cpu", "--data_root", root, "--epochs", "1",
        "--augmentation", "0", *SMALL_FLAGS]], str(d), cwd=str(d / "run"))
    _, batches, variables = request.getfixturevalue("setup")
    r = tmp_path_factory.mktemp("ranks")
    inputs = {f"w/{k}": v.numpy()
              for k, v in from_jax_variables(variables).items()}
    inputs.update({f"b{i}/{k}": v for i, b in enumerate(batches)
                   for k, v in b.items()})
    inputs["config"] = np.asarray(json.dumps(SMALL))
    inputs["lr_clip"] = np.asarray([LR, CLIP])
    np.savez(r / "in.npz", **inputs)
    port = _free_port()
    ranks = _Processes(
        [[sys.executable, os.path.abspath(__file__), str(r / "in.npz"),
          str(rank), str(port), str(r / f"out{rank}.npz")]
         for rank in range(2)], str(r))
    yield {"cli": (d, cli), "ranks": (r, ranks)}
    for group in (cli, ranks):
        group.kill()
    for folder in (d, r):
        shutil.rmtree(folder, ignore_errors=True)


# -- the valid row mask --------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    """test_torch_train.py's weights and batches, and JAX's step with its
    options."""
    jcfg = JaxConfig(**SMALL)
    jmodel = JaxBeamFuser(jcfg)
    batches = _batches(2)
    variables = randomized(jinit(jmodel, *(jnp.asarray(batches[0][k])
                                           for k in INPUTS)), 13)
    tx = jax_state.make_optimizer()
    jstep = jax_steps.make_train_step(jmodel, jcfg, tx, use_ema=True,
                                      clip_grad_norm=CLIP)

    def run(batch, jstate=None):
        """One JAX step; every batch carries ``valid`` (all ones where it
        is not padded, which computes the unmasked step), so that one
        traced program serves every test here."""
        if jstate is None:
            jstate = jax_state.create_train_state(_copy(variables), tx)
        if "valid" not in batch:
            batch = {**batch, "valid": np.ones(len(batch["image"]),
                                               np.float32)}
        return jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                     LR)

    return run, batches, jax.device_get(variables)


@pytest.fixture(scope="module")
def padded_steps(setup, started):
    """One step on the first sample alone, padded to two rows: JAX's step
    and the port's with ``valid``, and the port's on the one row."""
    jax_step, batches, variables = setup
    one = {k: v[:1] for k, v in batches[0].items()}
    padded = pad_batch(one, B)
    assert list(padded["valid"]) == [1.0, 0.0]
    jstate, jm = jax_step(padded)
    out = {"jax": (_jax_snapshot(jstate), float(jm["loss"]),
                   np.asarray(jm["ranks"]))}
    for name, batch in (("padded", padded), ("one", one)):
        model = _port_model(variables)
        state = create_train_state(model)
        m = steps.make_train_step(model, model.config, state, use_ema=True,
                                  clip_grad_norm=CLIP, device="cpu")(batch, LR)
        out[name] = (_snapshot(state), float(m["loss"]), _np(m["ranks"]))
    return out


def _compare_steps(got, want, loss_rtol, stats_rtol):
    (snap, loss, ranks), (wsnap, wloss, wranks) = got, want
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, wloss, rtol=loss_rtol)
    np.testing.assert_array_equal(ranks[:1, :3], wranks[:1, :3])
    _assert_envelope(snap["params"], wsnap["params"], _params_envelope(1),
                     "params")
    _assert_envelope(snap["ema"], wsnap["ema"], _ema_envelope(1), "ema")
    _assert_envelope(snap["stats"], wsnap["stats"], _stats_tol(stats_rtol),
                     "batch_stats")


def test_valid_step_matches_jax(padded_steps):
    _compare_steps(padded_steps["padded"], padded_steps["jax"], 1e-5, 1e-4)


def test_padded_batch_equals_unpadded(padded_steps):
    """The padded row changes nothing but rounding: the loss to 1e-6, the
    statistics to 1e-5 of a leaf's largest."""
    _compare_steps(padded_steps["padded"], padded_steps["one"], 1e-6, 1e-5)


# -- two ranks against JAX's step on the global batch -------------------------

@pytest.fixture(scope="module")
def two_ranks(setup, started):
    """Two gloo ranks, one row of each global batch apiece, two steps from
    the JAX weights (rank 1 starts from perturbed ones, which the state's
    broadcast overwrites), against JAX's two steps on the global batches."""
    jax_step, batches, _ = setup
    jstate, want = None, []
    for b in batches:
        jstate, jm = jax_step(b, jstate)
        want.append((_jax_snapshot(jstate), float(jm["loss"]),
                     np.asarray(jm["ranks"])))
    d, procs = started["ranks"]
    procs.wait()
    outs = [dict(np.load(d / f"out{r}.npz")) for r in range(2)]
    shutil.rmtree(d)        # ~0.5 GB of arrays, now in memory
    return outs, want


def _rank_snapshot(out, i):
    return {kind: {k.split("/", 2)[2]: torch.from_numpy(v)
                   for k, v in out.items() if k.startswith(f"{i}/{kind}/")}
            for kind in ("params", "ema", "stats")}


@pytest.mark.parametrize("i", [0, 1])
def test_two_rank_loss_and_ranks_match_jax(two_ranks, i):
    """The loss is the global batch's on both ranks; rank r's ranks are
    the global row r's.  Tolerances of tests/test_torch_train.py."""
    outs, want = two_ranks
    _, wloss, wranks = want[i]
    for out in outs:
        np.testing.assert_allclose(float(out[f"{i}/loss"]), wloss,
                                   rtol=(1e-5, 1e-3)[i])
    ranks = np.concatenate([out[f"{i}/ranks"] for out in outs])
    assert ranks.shape == (B, 64)
    np.testing.assert_array_equal(ranks[:, :3], wranks[:, :3])


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("what", ["params", "ema"])
def test_two_rank_params_and_ema_match_jax(two_ranks, i, what):
    outs, want = two_ranks
    envelope = (_params_envelope if what == "params" else _ema_envelope)(i + 1)
    _assert_envelope(_rank_snapshot(outs[0], i)[what], want[i][0][what],
                     envelope, what)


@pytest.mark.parametrize("i", [0, 1])
def test_two_rank_batch_stats_match_jax(two_ranks, i):
    """BatchNorm's statistics over both ranks' rows are the global
    batch's."""
    outs, want = two_ranks
    _assert_envelope(_rank_snapshot(outs[0], i)["stats"], want[i][0]["stats"],
                     _stats_tol((1e-4, 2e-3)[i]), "batch_stats")


def test_two_ranks_stay_bit_equal(two_ranks):
    """After every step, every parameter, EMA tensor, statistic and the
    loss, and the probe's gradients, are the same bits on both ranks (rank
    1 started from other weights: the broadcast replaced them): their
    sha256 digests agree."""
    (a, b), _ = two_ranks
    da, db = (json.loads(str(out["digests"])) for out in (a, b))
    assert set(da) == set(db) and len(da) > 100
    assert [k for k in da if da[k] != db[k]] == []


def test_two_rank_gradient_is_the_global_batch_gradient(two_ranks):
    """Unclipped, the summed gradient of the two ranks' shares is one
    process's gradient of the global batch's mean loss, from the same
    weights, to test_torch_train.py's bound of the norm: only the order of
    BatchNorm's sums differs, but BatchNorm's variance cancels and a ReLU
    input that close to 0 switches sides (measured 5.5e-4).  An average
    in place of the sum would be 0.5 off."""
    (a, _), _ = two_ranks
    diff, norm = a["probe_gap"]
    assert norm > 0 and diff <= GRAD_RTOL_MODEL * norm, diff / norm


def test_two_rank_broadcast_str_and_process_info(two_ranks):
    outs, _ = two_ranks
    for rank, out in enumerate(outs):
        assert str(out["broadcast"]) == "from rank 0"
        assert json.loads(str(out["info"])) == {
            "process_index": rank, "process_count": 2, "local_devices": 1,
            "global_devices": 2, "backend": "gloo"}


# -- the process group ---------------------------------------------------------

@pytest.mark.parametrize("n,nproc", [(10, 2), (10, 3), (7, 4)])
def test_shard_for_process_matches_jax(n, nproc):
    from deepsense6g_tii_tpu.data import dataset as jds
    from deepsense6g_tii_tpu_torch.data import dataset as ds
    data = list(range(n))
    for pid in range(nproc):
        got = ds.shard_for_process(data, pid, nproc)
        want = jds.shard_for_process(data, pid, nproc)
        np.testing.assert_array_equal(got.indices, want.indices)
    assert ds.shard_for_process(data, 0, 1) is data
    with pytest.raises(ValueError, match="cannot be sharded"):
        ds.shard_for_process([0], 0, 2)


def test_initialize_without_a_launcher(monkeypatch):
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        distributed.initialize(require=True)
    assert distributed.process_info() == {
        "process_index": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}
    assert distributed.broadcast_str("x") == "x"
    distributed.barrier("alone")


@pytest.mark.parametrize("variables", ["deepsense", "launcher"])
def test_initialize_from_env(monkeypatch, variables):
    """A one-process group from the JAX package's variables or the
    launcher's; a second call is a no-op."""
    for name in LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)
    port = str(_free_port())
    env = ({"DEEPSENSE_COORDINATOR": f"127.0.0.1:{port}",
            "DEEPSENSE_NUM_PROCESSES": "1", "DEEPSENSE_PROCESS_ID": "0"}
           if variables == "deepsense" else
           {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
            "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0"})
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert distributed.initialize(require=True)
        assert distributed.initialize()
        assert torch.distributed.get_backend() == "gloo"
        assert distributed.process_info()["process_count"] == 1
        assert distributed.broadcast_str("y") == "y"
    finally:
        distributed.shutdown()
    assert not torch.distributed.is_initialized()


# -- the train CLI over two processes ----------------------------------------

@pytest.fixture(scope="module")
def multihost_cli(started):
    """The run's logdirs, the files of each and the rank-prefixed lines of
    each rank's output; the run's directory is removed (its checkpoints
    take ~0.4 GB)."""
    d, procs = started["cli"]
    (out,) = procs.wait()
    ranks = [[line.split(":", 1)[1] for line in out.splitlines()
              if line.startswith(f"[default{r}]:")] for r in range(2)]
    log = d / "run" / "log"
    runs = {run: {f: (open(log / run / f).read() if f.endswith(
        (".log", ".txt", ".jsonl")) else None)
        for f in os.listdir(log / run)} for run in os.listdir(log)}
    shutil.rmtree(d)
    return runs, ranks


def test_multihost_cli_one_logdir(multihost_cli):
    """Both ranks trained, validated and saved into one logdir."""
    runs, ranks = multihost_cli
    (files,) = runs.values()
    rec = json.loads(files["recent.log"])
    assert rec["epoch"] == 1 and len(rec["DBA"]) == 1
    for f in ("final_model.pt", "best_model.pt", "best_optim.pt",
              "args.txt", "scalars.jsonl"):
        assert f in files, f
    for r, lines in enumerate(ranks):
        info = [x for x in lines if x.startswith("distributed:")]
        assert info and f"'process_index': {r}" in info[0]
        assert "'process_count': 2" in info[0]


def test_multihost_cli_rank0_writes_only(multihost_cli):
    """One scalar stream and one event file: rank 1 logged nothing (its
    lines would double the stream), and wrote no checkpoint of its own."""
    runs, _ = multihost_cli
    (files,) = runs.values()
    assert len([f for f in files if f.startswith("events.out")]) == 1
    assert not [f for f in files if f.endswith(".tmp")]
    tags = [json.loads(x)["tag"]
            for x in files["scalars.jsonl"].splitlines()]
    assert tags.count("DBA_score_train") == 1
    assert tags.count("DBA_score_val/scenario_all") == 1
    args = json.loads(files["args.txt"])
    assert args["multihost"] == 1 and args["batch_size"] == 4


def test_multihost_cli_dba_agrees(multihost_cli):
    """The train DBA (over both ranks' gathered rows) and the validation
    DBA (the full split on each rank) are the same on both ranks."""
    _, ranks = multihost_cli
    picked = [[x for x in lines if "DBA score" in x] for lines in ranks]
    assert len(picked[0]) == 2 and picked[0] == picked[1]
    train = [x for x in ranks[0] if x.startswith("train_set:")]
    assert train and all(x in ranks[1] for x in train)


# -- serving over a mesh -------------------------------------------------------

@pytest.fixture(scope="module")
def predictors():
    cfg = GlobalConfig(**SMALL)
    model = BeamFuser(cfg, device="cpu")
    one = serve_predictor(model, cfg, False)
    mesh = serve_predictor(model, cfg, Mesh(["cpu", "cpu"]))
    return cfg, one, mesh


def serve_predictor(model, cfg, use_mesh):
    from deepsense6g_tii_tpu_torch.serve import Predictor
    return Predictor(model, cfg, batch_buckets=(1, 2), device="cpu",
                     use_mesh=use_mesh)


def _request(cfg, n, seed=0):
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
    b = make_synth_batch(cfg, n, seed=seed, with_labels=False)
    return [b[k] for k in INPUTS]


@pytest.mark.parametrize("n", [4, 3])
def test_mesh_predictor_matches_one_device(predictors, n):
    """Two replicas, two rows each of bucket 2 x 2 devices, against one
    device on the same rows; a ragged 3 pads to that bucket (JAX
    ``tests/test_serve.py:97-130``)."""
    cfg, one, mesh = predictors
    assert mesh.n_devices == 2 and mesh._bucket(n) == 4
    assert mesh.replicas[1] is not mesh.model
    req = _request(cfg, n)
    beams_m, conf_m = mesh.predict(*req)
    beams_s, conf_s = one.predict(*req)
    assert beams_m.shape == (n, 3) and conf_m.shape == (n,)
    np.testing.assert_array_equal(beams_m, beams_s)
    np.testing.assert_allclose(conf_m, conf_s, rtol=1e-5, atol=1e-6)


def test_mesh_export_batch_is_bucket_times_devices(predictors, monkeypatch):
    """The artifact's default batch is the largest bucket times the
    devices (JAX ``serve.py:159-160``); the trace itself is
    tests/test_torch_export.py's."""
    _, one, mesh = predictors
    seen = []
    monkeypatch.setattr(torch.export, "export",
                        lambda mod, args, **kw: seen.append(args[0].shape[0]))
    mesh.export_program()
    one.export_program()
    assert seen == [4, 2]
    with pytest.raises(ValueError, match="first device"):
        serve_predictor(mesh.model, mesh.config, Mesh(["meta", "cpu"]))


@pytest.mark.parametrize("n_devices", [1, 2])
def test_engine_takes_one_device_a_rank(predictors, tmp_path, n_devices):
    """The engine trains on one device a rank: a mesh of several local
    devices (a serving mesh) is refused; with one, a ragged batch goes to
    the device as it is, its rows neither padded nor masked."""
    from deepsense6g_tii_tpu_torch.train import engine as pengine
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
    cfg, one, _ = predictors
    opts = pengine.TrainOptions(logdir=str(tmp_path / "run"))
    mesh = Mesh(["cpu"] * n_devices)
    if n_devices > 1:
        with pytest.raises(ValueError, match="serving mesh"):
            pengine.Engine(one.model, cfg, opts, device="cpu", mesh=mesh)
        return
    eng = pengine.Engine(one.model, cfg, opts, device="cpu", mesh=mesh)
    dev, event = eng._to_device(make_synth_batch(cfg, 3, seed=0))
    assert event is None and "valid" not in dev
    assert {len(t) for t in dev.values()} == {3}


# -- the rank worker -------------------------------------------------------------

def _worker(npz, rank, port, out):
    """Two steps on this rank's rows of each global batch in a 2-rank gloo
    group; writes to ``out`` everything the tests compare."""
    torch.set_num_threads(2)
    import hashlib

    from deepsense6g_tii_tpu_torch.config import GlobalConfig
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.parallel import distributed
    from deepsense6g_tii_tpu_torch.parallel.mesh import make_mesh
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step

    rank = int(rank)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, require=True)
    inp = np.load(npz)
    small = json.loads(str(inp["config"]))
    small["backbone_blocks"] = tuple(small["backbone_blocks"])
    cfg = GlobalConfig(**small)
    model = BeamFuser(cfg, device="cpu")
    weights = {k[2:]: torch.from_numpy(inp[k]) for k in inp.files
               if k.startswith("w/")}
    if rank:        # other weights: the state's broadcast replaces them
        weights = {k: v + 0.01 if v.is_floating_point() else v
                   for k, v in weights.items()}
    model.load_state_dict(weights, strict=True)
    mesh = make_mesh()
    state = create_train_state(model, mesh=mesh)
    lr, clip = (float(x) for x in inp["lr_clip"])
    step = make_train_step(model, cfg, state, use_ema=True,
                           clip_grad_norm=clip, device="cpu")
    res = {"broadcast": np.asarray(distributed.broadcast_str(
        f"from rank {rank}")),
        "info": np.asarray(json.dumps(distributed.process_info()))}
    digests = {}

    def keep(key, tensor):
        """Every rank's digest of a tensor; rank 0's values too (one copy
        is all the comparisons with JAX need)."""
        a = tensor.detach().numpy()
        digests[key] = hashlib.sha256(a.tobytes()).hexdigest()
        if rank == 0:
            res[key] = a.copy()

    for i in range(2):
        batch = {k.split("/", 1)[1]: v for k, v in
                 ((k, inp[k]) for k in inp.files if k.startswith(f"b{i}/"))}
        rows = mesh.rows(len(batch["image"]))
        m = step({k: v[rows] for k, v in batch.items()}, lr)
        keep(f"{i}/loss", m["loss"])
        res[f"{i}/loss"] = m["loss"].numpy()
        res[f"{i}/ranks"] = m["ranks"].numpy()
        for n, p in model.named_parameters():
            keep(f"{i}/params/{n}", p)
        for n, e in state.ema.items():
            keep(f"{i}/ema/{n}", e)
        for n, b in model.named_buffers():
            keep(f"{i}/stats/{n}", b)
    # the gradient's scale, which the clip and AdamW's first steps hide:
    # one more step, unclipped at lr 0, against one process's on the whole
    # global batch from the same weights
    probe = make_train_step(model, cfg, state, device="cpu")
    ref = BeamFuser(cfg, device="cpu")
    ref.load_state_dict(model.state_dict())
    ref_step = make_train_step(ref, cfg, create_train_state(ref),
                               device="cpu")
    batch = {k.split("/", 1)[1]: inp[k] for k in inp.files
             if k.startswith("b0/")}
    probe({k: v[mesh.rows(len(batch["image"]))] for k, v in batch.items()},
          0.0)
    ref_step(batch, 0.0)
    grads = dict(ref.named_parameters())
    for n, p in model.named_parameters():
        digests[f"probe/{n}"] = hashlib.sha256(
            p.grad.numpy().tobytes()).hexdigest()
    res["probe_gap"] = np.asarray([
        sum(float(((p.grad - grads[n].grad).double() ** 2).sum())
            for n, p in model.named_parameters()),
        sum(float((grads[n].grad.double() ** 2).sum()) for n in grads)]) ** 0.5
    res["digests"] = np.asarray(json.dumps(digests))
    distributed.barrier("written")
    np.savez(out, **res)
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
