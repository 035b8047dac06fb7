"""PyTorch port, data parallelism on the CPU: 2 gloo ranks against 1 process
and against the JAX package's data-parallel step on a 2-device mesh.

Ranks are processes started by ``subprocess`` running this file as a
script (``python tests/test_torch_port_parallel.py <job> ...``); a worker
imports torch and the port only, never JAX (the test process has loaded
JAX, so a fork would be unsafe). Each worker rendezvouses through the
``DAHPE_*`` contract on a free loopback port with a 60 s timeout, runs
one thread, and is given 180 s. One ``steps`` job per module computes the
cross-rank batch norm, the DA step (gate off and at 0.5), the pretrain
step, the eval step, the stop consensus and the state helpers on the mini
``[1, 1, 1, 1]`` backbone at 64²/16² with global batches of 8; the tests
below compare its outputs. Tolerances: cross-rank BN against one process
on the concatenated batch atol 1e-5; the 2-rank DA and pretrain steps
against one process, losses rel 1e-4 and every parameter and BN statistic
within 1e-4; against JAX, the DA parity tolerance of
``tests/test_da_parity.py:221-223`` (rtol 5e-3, atol 5e-5) on its
``0.05·randn`` weights.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    from tests.conftest import REPO_ROOT
else:
    REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, REPO_ROOT)

WORLD, B, IMAGE, HM, K, C = 2, 8, 64, 16, 21, 6
GATES = (None, 0.5)
TIMEOUT = 180


# --------------------------------------------------------------------------
# the worker (a rank): torch and the port only
# --------------------------------------------------------------------------

def _mini_model(pose=False):
    from dahpe_tpu_torch import models

    backbone = models.ResNet(models.Bottleneck, [1, 1, 1, 1])
    if pose:
        return models.PoseResNet(backbone, num_keypoints=K)
    return models.MultiHeadPoseResNet(backbone, num_keypoints=K)


def _to_torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def bn_case(x, g, collectives=None):
    """One training forward and backward of a BatchNorm2d on ``x`` with the
    loss ``mean(y·g)``: output, input gradient, weight and bias gradients
    (averaged over the ranks when ``collectives`` is given) and running
    statistics."""
    from dahpe_tpu_torch.models.batch_norm import BatchNorm2d, set_process_group

    bn = BatchNorm2d(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, x.shape[1]))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, x.shape[1]))
    if collectives is not None:
        set_process_group(bn)
    x = x.clone().requires_grad_(True)
    y = bn(x)
    (y * g).mean().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    if collectives is not None:
        collectives.grads(("bn",), grads)
    return {"y": y.detach(), "dx": x.grad, "dweight": grads[0], "dbias": grads[1],
            "running_mean": bn.running_mean, "running_var": bn.running_var,
            "num_batches_tracked": bn.num_batches_tracked}


def da_steps(weights, batches, gate, parallel_step, *, cross_rank=False, dtype=None):
    """Two DA iterations from ``weights`` on ``batches``: each iteration's
    losses and accuracies, and the final state dict. ``cross_rank`` forces
    every BatchNorm2d into its cross-rank mode over the process group that
    is up (``set_process_group`` keeps a group of one rank local);
    ``dtype`` runs the model and batches in that dtype."""
    from dahpe_tpu_torch.models.batch_norm import BatchNorm2d
    from dahpe_tpu_torch.train import create_da_state, make_da_train_step

    model = _mini_model()
    model.load_state_dict(weights)
    if cross_rank:
        for mod in model.modules():
            if isinstance(mod, BatchNorm2d):
                mod._cross_rank = True
    if dtype is not None:
        model.to(dtype)
        batches = [tuple({k: v.to(dtype) for k, v in b.items()} for b in pair)
                   for pair in batches]
    state = create_da_state(model, device="cpu")
    make = parallel_step or make_da_train_step
    step = make(model, conf_gate=gate, compute_metrics=True)
    metrics = []
    for b_s, b_t in batches:
        state, m = step(state, b_s, b_t)
        metrics.append({k: float(m[k]) for k in ("loss_s", "loss_gf", "loss_gt", "acc_s",
                                                 "acc_t", "acc_s_adv", "acc_t_adv")})
    return {"metrics": metrics, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def pretrain_step(weights, batch, parallel_step):
    from dahpe_tpu_torch.train import create_pretrain_state, make_pretrain_step

    model = _mini_model(pose=True)
    model.load_state_dict(weights)
    state = create_pretrain_state(model, device="cpu")
    state, m = (parallel_step or make_pretrain_step)(model)(state, batch, 0.05)
    return {"loss_s": float(m["loss_s"]), "acc_s": float(m["acc_s"]),
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _stop_consensus(rank):
    """Rank 1 alone sets its stop flag during step 3; the poller, called
    after every step with the steps done, reduces the flags every 2 steps:
    the step each rank stops at."""
    import signal

    from dahpe_tpu_torch.cli.train import make_stop_poller

    flag = []
    poll = make_stop_poller(flag, every=2)
    for step in range(1, 11):
        if rank == 1 and step == 3:
            flag.append(int(signal.SIGTERM))
        if poll(step) is not None:
            return step
    return None


def _worker_steps(rank, inputs, out):
    from dahpe_tpu_torch import parallel
    from dahpe_tpu_torch.utils import checkpoint as ckpt

    parallel.robust_distributed_initialize("cpu")
    assert (parallel.rank(), parallel.world_size()) == (rank, WORLD)
    data = torch.load(inputs, weights_only=False)
    res = {"bn": bn_case(parallel.shard_batch(data["bn_x"]), parallel.shard_batch(data["bn_g"]),
                         parallel.Collectives())}
    batches = [(_to_torch(parallel.shard_batch(s)), _to_torch(parallel.shard_batch(t)))
               for s, t in data["da_batches"]]
    for gate in GATES:
        res[f"da_{gate}"] = da_steps(data["da_weights"], batches, gate,
                                     parallel.make_parallel_da_step)
    res["pretrain"] = pretrain_step(data["pretrain_weights"],
                                    _to_torch(parallel.shard_batch(data["pretrain_batch"])),
                                    parallel.make_parallel_pretrain_step)
    # the eval step: this rank's rows, gathered into the global heatmaps
    model = _mini_model()
    model.load_state_dict(data["da_weights"])
    res["eval_heatmaps"] = parallel.make_parallel_eval_step(model, device="cpu")(
        torch.from_numpy(data["da_batches"][0][0]["image"]))
    res["stop_step"] = _stop_consensus(rank)
    # replicate: rank 1's copy is moved off, then made rank 0's again
    if rank == 1:
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    parallel.replicate(model)
    res["replicated"] = parallel.assert_replicated(model)
    gen = torch.Generator().manual_seed(parallel.fold_in(5, rank))
    res["gen_state"] = gen.get_state()
    res["gathered_states"] = ckpt.gather_stream_states({"key_s": gen.get_state()})["key_s"]
    res["mesh"] = [str(d) for d in parallel.create_mesh()]
    # each rank's place among the ranks on its host: one host, then two
    # (each rank reporting a host name of its own)
    res["local_place"] = parallel.distributed.local_rank_and_size()
    hostname = socket.gethostname
    socket.gethostname = lambda: f"host{rank}"
    try:
        res["local_place_two_hosts"] = parallel.distributed.local_rank_and_size()
    finally:
        socket.gethostname = hostname
    torch.save(res, out)
    parallel.shutdown()


def _worker_one_rank_group(inputs, out):
    """A process group of one rank (gloo), the DA iterations with every
    batch norm forced into the cross-rank mode on it: the formula
    ``E[x²] - E[x]²`` and the all-reduce path without a split batch."""
    from dahpe_tpu_torch import parallel

    parallel.robust_distributed_initialize("cpu")
    assert parallel.world_size() == 1
    data = torch.load(inputs, weights_only=False)
    batches = [(_to_torch(s), _to_torch(t)) for s, t in data["da_batches"]]
    torch.save({"da": da_steps(data["da_weights"], batches, None, None, cross_rank=True)}, out)
    parallel.shutdown()


def _worker(argv):
    job, port, rank, inputs, out = argv
    world = 1 if job == "one_rank_group" else WORLD
    os.environ.update(DAHPE_COORDINATOR=f"127.0.0.1:{port}", DAHPE_NUM_PROCESSES=str(world),
                      DAHPE_PROCESS_ID=rank, DAHPE_DIST_INIT_TIMEOUT="60")
    torch.set_num_threads(1)
    if job == "steps":
        _worker_steps(int(rank), inputs, out)
    elif job == "one_rank_group":
        _worker_one_rank_group(inputs, out)
    else:
        raise SystemExit(f"unknown job {job}")


if __name__ == "__main__":
    _worker(sys.argv[1:])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dahpe_tpu_torch import parallel  # noqa: E402
from dahpe_tpu_torch.utils.torch_import import state_dict_from_jax  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "DAHPE_", "MASTER_", "WORLD_", "RANK",
                                "LOCAL_RANK"))}
    env.update(PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1", **extra)
    return env


class Ranks:
    """One process per command (rank order), started at once; :meth:`wait`
    requires every one to exit 0 within the timeout and returns their
    outputs."""

    def __init__(self, commands, env_for_rank=None):
        self.procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True, cwd=REPO_ROOT,
                                       env=env_for_rank(r) if env_for_rank else _env())
                      for r, cmd in enumerate(commands)]
        self.outs = None

    def wait(self):
        if self.outs is None:
            outs = []
            try:
                for p in self.procs:
                    outs.append(p.communicate(timeout=TIMEOUT)[0])
            finally:
                self.kill()
            for p, out in zip(self.procs, outs):
                assert p.returncode == 0, f"rank failed ({p.returncode}):\n{out[-4000:]}"
            self.outs = outs
        return self.outs

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _da_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        pair = []
        for _ in range(2):
            pair.append({
                "image": rng.standard_normal((B, IMAGE, IMAGE, 3)).astype(np.float32),
                "target": np.clip(rng.standard_normal((B, HM, HM, K)), 0, None).astype(np.float32),
                "weight": (rng.uniform(size=(B, K)) > 0.2).astype(np.float32),
            })
        out.append(tuple(pair))
    return out


def _cli_argv(roots, log, *extra):
    rhd, h3d = roots
    return [sys.executable, "-m", "dahpe_tpu_torch.cli.train", h3d, "--source_root", rhd,
            "-t", "Hand3DStudio", "-a", "resnet18", "-b", "4", "-i", "4", "--workers", "1",
            "--print-freq", "2", "--image-size", "64", "--heatmap-size", "16", "--device", "cpu",
            "--device-store", "--pretrain-epochs", "0", "--epochs", "1", "--multihost",
            "--log", str(log), *extra]


def _cli_job(roots, root, name, *extra, resume=False):
    """``cli.train --multihost`` on 2 gloo ranks, each with its own log
    directory ``{root}/{name}_{rank}`` (rank 0 alone may write there);
    ``resume`` continues from each rank's ``cut_{rank}/checkpoints/latest``
    (only rank 0's exists)."""
    port = _free_port()

    def env(r):
        return _env(DAHPE_COORDINATOR=f"127.0.0.1:{port}", DAHPE_NUM_PROCESSES=str(WORLD),
                    DAHPE_PROCESS_ID=str(r), DAHPE_DIST_INIT_TIMEOUT="60")

    return Ranks([_cli_argv(roots, root / f"{name}_{r}", *extra,
                            *(("--resume", str(root / f"cut_{r}" / "checkpoints" / "latest"))
                              if resume else ()))
                  for r in range(WORLD)], env)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The inputs (weights from the JAX package's DA parity recipe, global
    batches) and the rank jobs, all started at once: the ``steps`` job, the
    ``one_rank_group`` job (batch norm forced cross-rank on a group of one
    rank) and two ``cli.train --multihost`` runs (``--max-steps 4``, and 2
    to resume from). They run while the tests compute their references."""
    from dahpe_tpu import models as jmodels
    from tests.fixtures import make_h3d_fixture, make_rhd_fixture
    from tests.test_torch_port_models import jax_backbone
    from tests.test_torch_port_train import da_variables

    jmodel = jmodels.MultiHeadPoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    variables = da_variables(jmodel, 0, gl_coeff=0.0)
    jpose = jmodels.PoseResNet(backbone=jax_backbone("bottleneck"), num_keypoints=K)
    pose_variables = da_variables(jpose, 6)
    rng = np.random.default_rng(1)
    inputs = {
        "bn_x": torch.from_numpy((rng.standard_normal((B, C, 5, 7)) * 2 + 0.5).astype(np.float32)),
        "bn_g": torch.from_numpy(rng.standard_normal((B, C, 5, 7)).astype(np.float32)),
        "da_weights": state_dict_from_jax(variables),
        "da_batches": _da_batches(8),
        "pretrain_weights": state_dict_from_jax(pose_variables),
        "pretrain_batch": _da_batches(9)[0][0],
    }
    root = tmp_path_factory.mktemp("parallel")
    path = str(root / "inputs.pt")
    torch.save(inputs, path)
    port = _free_port()
    outs = [str(root / f"out{r}.pt") for r in range(WORLD)]
    steps = Ranks([[sys.executable, __file__, "steps", str(port), str(r), path, outs[r]]
                   for r in range(WORLD)])
    one_rank_out = str(root / "one_rank_group.pt")
    one_rank = Ranks([[sys.executable, __file__, "one_rank_group", str(_free_port()), "0", path,
                       one_rank_out]])
    roots = (make_rhd_fixture(str(root / "rhd"), n=6, sets=("training", "evaluation")),
             make_h3d_fixture(str(root / "h3d"), n=20))
    cli = {"straight": _cli_job(roots, root, "straight", "--max-steps", "4"),
           "cut": _cli_job(roots, root, "cut", "--max-steps", "2")}
    yield {"jmodel": jmodel, "variables": variables, "inputs": inputs, "steps": steps,
           "outs": outs, "cli": cli, "roots": roots, "root": root, "one_rank": one_rank,
           "one_rank_out": one_rank_out}
    for job in (steps, one_rank, *cli.values()):
        job.kill()


@pytest.fixture(scope="module")
def setup(jobs):
    """The ``steps`` job's outputs, one dict a rank, beside the inputs."""
    jobs["steps"].wait()
    return {**jobs, "ranks": [torch.load(o, weights_only=False) for o in jobs["outs"]]}


def _rows(x, r):
    return x[r * (x.shape[0] // WORLD):(r + 1) * (x.shape[0] // WORLD)]


def test_cross_rank_bn_is_f_batch_norm_without_a_group_and_at_world_one():
    """Without a process group, and in cross-rank mode over a group of one
    rank, the layer is ``nn.BatchNorm2d``'s forward: bit for bit in output,
    input and parameter gradients and running statistics."""
    import datetime

    import torch.distributed as dist

    from dahpe_tpu_torch.models.batch_norm import BatchNorm2d, set_process_group

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, C, 3, 5)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((4, C, 3, 5)).astype(np.float32))

    def plain(x):
        bn = torch.nn.BatchNorm2d(C)
        with torch.no_grad():
            bn.weight.copy_(torch.linspace(0.5, 1.5, C))
            bn.bias.copy_(torch.linspace(-0.2, 0.2, C))
        x = x.clone().requires_grad_(True)
        y = bn(x)
        (y * g).mean().backward()
        return [y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var]

    def ours(x, collectives=None):
        r = bn_case(x, g, collectives)
        return [r[k] for k in ("y", "dx", "dweight", "dbias", "running_mean", "running_var")]

    want = plain(x)
    assert all(torch.equal(a, b) for a, b in zip(ours(x), want))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        probe = set_process_group(BatchNorm2d(C))
        assert not probe._cross_rank  # one rank: the local layer
        assert all(torch.equal(a, b) for a, b in zip(ours(x, parallel.Collectives()), want))
    finally:
        dist.destroy_process_group()


_JAX_RUNS = {}  # (devices, gate, iterations) -> (losses per iteration, final tree)


def jax_parallel_run(jobs, n, gate, iterations=2):
    """The JAX package's ``make_parallel_da_step`` on an ``n``-device mesh
    from the inputs' weights over the first ``iterations`` global batches."""
    from dahpe_tpu.parallel import create_mesh, make_parallel_da_step, replicate, shard_batch
    from dahpe_tpu.train import DATrainState
    from dahpe_tpu.train.optim import DA_PARTITIONS, init_partitioned, torch_sgd

    key = (n, gate, iterations)
    if key not in _JAX_RUNS:
        variables = jobs["variables"]
        params = jax.tree.map(jnp.asarray, variables["params"])
        jstate = DATrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                              opt=init_partitioned(torch_sgd(), params, DA_PARTITIONS),
                              ema_params=None, ema_batch_stats=None)
        mesh = create_mesh(jax.devices()[:n])
        step = make_parallel_da_step(jobs["jmodel"], mesh, conf_gate=gate,
                                     compute_metrics=False)
        jstate, losses = replicate(jstate, mesh), []
        for b_s, b_t in jobs["inputs"]["da_batches"][:iterations]:
            jstate, jm = step(jstate, shard_batch(b_s, mesh), shard_batch(b_t, mesh))
            losses.append({k: float(jm[k]) for k in ("loss_s", "loss_gf", "loss_gt")})
        _JAX_RUNS[key] = (losses, jax.tree.map(np.asarray, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
    return _JAX_RUNS[key]


def test_jax_gate_quantile_is_global(jobs):
    """The trap: ``dahpe_tpu/train/da.py``'s gate comment says the quantile
    is per-shard, but the data-parallel step is a plain ``jit`` with
    shardings, so it is the global batch's: its gated losses on 2 devices
    equal those on 1, while a per-shard quantile would keep other target
    samples of this batch."""
    _, b_t = jobs["inputs"]["da_batches"][0]
    conf = b_t["target"].max(axis=(1, 2))  # any (B, K) confidences will do
    whole = conf >= np.quantile(conf, 0.5, axis=0)
    per_shard = np.concatenate([c >= np.quantile(c, 0.5, axis=0)
                                for c in np.split(conf, WORLD)])
    assert (whole != per_shard).any()
    one = jax_parallel_run(jobs, 1, 0.5, iterations=1)[0][0]
    two = jax_parallel_run(jobs, WORLD, 0.5)[0][0]
    for k in ("loss_gf", "loss_gt"):
        np.testing.assert_allclose(two[k], one[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("gate", GATES, ids=["gate-off", "gate-0.5"])
def test_da_step_on_two_ranks_matches_jax_data_parallel_step(jobs, gate):
    """Against the JAX package's ``make_parallel_da_step`` on a 2-device
    mesh with the same weights and global batches: the losses within rel
    1e-4 and every parameter and BN statistic at the DA parity tolerance."""
    from tests.test_torch_port_train import _worst_and_check

    losses, tree = jax_parallel_run(jobs, WORLD, gate)
    jobs["steps"].wait()
    got = torch.load(jobs["outs"][0], weights_only=False)[f"da_{gate}"]
    for m, jm in zip(got["metrics"], losses):
        for k, v in jm.items():
            np.testing.assert_allclose(m[k], v, rtol=1e-4, err_msg=k)
    _worst_and_check(tree, got["state"], f"2 ranks vs JAX 2 devices, gate {gate}")


def test_store_shards_follow_the_jax_assignment():
    """A sharded store holds rank r's rows ``[r·n/W, (r+1)·n/W)`` with n
    floored to a multiple of W, as the JAX package's store on a W-device
    mesh lays them out; given draws, each rank's batch equals the matching
    rows of the whole store's batch; seeds fold the rank in."""
    from dahpe_tpu.data.device_store import DeviceDataStore as JaxStore
    from dahpe_tpu.parallel import create_mesh

    from dahpe_tpu_torch.data.device_aug import draw_augment_params
    from dahpe_tpu_torch.data.device_store import DeviceDataStore
    from dahpe_tpu_torch.data.synthetic import SyntheticHands

    source = SyntheticHands(n=7, seed=3)
    whole = DeviceDataStore(source, device="cpu", raw_size=48, verbose=False)
    jstore = JaxStore(source, mesh=create_mesh(jax.devices()[:WORLD]), raw_size=48,
                      verbose=False)
    assert jstore.n == 6
    jimages = np.asarray(jstore.images)
    g = torch.Generator().manual_seed(0)
    params = draw_augment_params(g, 2, size=48, rotation=180.0, scale_range=(0.6, 1.3))
    cfg = dict(image_size=32, heatmap_size=8)
    for r in range(WORLD):
        shard = DeviceDataStore(source, device="cpu", raw_size=48, verbose=False,
                                shard=(r, WORLD))
        assert shard.n == 3
        np.testing.assert_array_equal(shard.images.numpy(), jimages[3 * r:3 * (r + 1)])
        np.testing.assert_array_equal(shard.images.numpy(), whole.images[3 * r:3 * (r + 1)])
        idx = torch.tensor([2, 0])
        got = shard.train_batch_from(idx, params, **cfg)
        want = whole.train_batch_from(idx + 3 * r, params, **cfg)
        assert all(torch.equal(got[k], want[k]) for k in want)
        assert shard.train_batch(5, 4, **cfg)["image"].shape[0] == 2  # 4 / W rows
        assert torch.equal(shard.generator(5).get_state(),
                           torch.Generator().manual_seed(parallel.fold_in(5, r)).get_state())
        with pytest.raises(ValueError, match="sharded"):
            shard.eval_loader(2)
    assert torch.equal(whole.generator(5).get_state(), torch.Generator().manual_seed(5).get_state())


def test_robust_distributed_initialize_retries(monkeypatch):
    """The counterpart of ``tests/test_parallel.py``'s: an explicit timeout
    and the rendezvous of the ``DAHPE_*`` contract on every attempt, the
    transient class retried with the half-made group destroyed in between,
    the retry budget bounded, and any other error re-raised at once."""
    import torch.distributed as dist

    from dahpe_tpu_torch.parallel import distributed

    calls = {"init": [], "shutdown": 0, "sleep": []}
    monkeypatch.setenv("DAHPE_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("DAHPE_NUM_PROCESSES", "2")
    monkeypatch.setenv("DAHPE_PROCESS_ID", "0")
    monkeypatch.setenv("DAHPE_DIST_INIT_TIMEOUT", "123")
    monkeypatch.setenv("DAHPE_DIST_INIT_RETRIES", "3")
    monkeypatch.setattr(distributed.time, "sleep", lambda s: calls["sleep"].append(s))
    monkeypatch.setattr(distributed, "shutdown",
                        lambda: calls.__setitem__("shutdown", calls["shutdown"] + 1))

    def flaky(**kw):
        calls["init"].append(kw)
        if len(calls["init"]) < 3:
            raise RuntimeError("Gloo connectFullMesh failed: Connect timeout")

    monkeypatch.setattr(dist, "init_process_group", flaky)
    assert distributed.robust_distributed_initialize("cpu", verbose=False) == torch.device("cpu")
    assert len(calls["init"]) == 3 and calls["shutdown"] == 2 and calls["sleep"] == [2.0, 4.0]
    assert all(kw["timeout"].total_seconds() == 123 and kw["backend"] == "gloo"
               and kw["init_method"] == "tcp://127.0.0.1:1" and kw["world_size"] == 2
               and kw["rank"] == 0 for kw in calls["init"])

    calls["init"].clear()

    def always(**kw):
        calls["init"].append(kw)
        raise RuntimeError("Deadline Exceeded")

    monkeypatch.setattr(dist, "init_process_group", always)
    with pytest.raises(RuntimeError, match="Deadline"):
        distributed.robust_distributed_initialize("cpu", verbose=False)
    assert len(calls["init"]) == 3

    calls["init"].clear()

    def fatal(**kw):
        calls["init"].append(kw)
        raise ValueError("world_size mismatch")

    monkeypatch.setattr(dist, "init_process_group", fatal)
    with pytest.raises(ValueError, match="mismatch"):
        distributed.robust_distributed_initialize("cpu", verbose=False)
    assert len(calls["init"]) == 1
    monkeypatch.setenv("DAHPE_DIST_BACKEND", "gloo")
    assert distributed.backend_for("cuda") == "gloo"
    monkeypatch.delenv("DAHPE_DIST_BACKEND")
    assert distributed.backend_for("cuda") == "nccl"


def test_rank_device_follows_the_ranks_on_its_host(setup, monkeypatch):
    """A rank's card is its place among the ranks on its own host, not its
    global rank: 2 gloo ranks on one host are local ranks 0 and 1 of 2, and
    each is local rank 0 of 1 when they report different host names. With
    a faked card count under NCCL, 2 hosts of 1 card each give every rank
    ``cuda:0``, 2 ranks on a 1-card host are refused, and gloo lets them
    share the card; ``torchrun``'s ``LOCAL_RANK``/``LOCAL_WORLD_SIZE``
    take precedence."""
    from dahpe_tpu_torch.parallel import distributed

    ranks = setup["ranks"]
    assert [res["local_place"] for res in ranks] == [(0, 2), (1, 2)]
    assert [res["local_place_two_hosts"] for res in ranks] == [(0, 1), (0, 1)]
    hosts = ["a", "b", "a", "b"]
    assert [distributed.local_place(hosts, r) for r in range(4)] == [(0, 2), (0, 2), (1, 2),
                                                                      (1, 2)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("DAHPE_DIST_BACKEND", raising=False)
    assert distributed.rank_device("cuda", 0, 1) == torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="2 ranks on this host but 1 CUDA device"):
        distributed.rank_device("cuda", 1, 2)
    monkeypatch.setenv("DAHPE_DIST_BACKEND", "gloo")
    assert distributed.rank_device("cuda", 1, 2) == torch.device("cuda", 0)
    assert distributed.rank_device("cpu", 1, 2) == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert distributed.local_rank_and_size() == (3, 4)


def test_mesh_predict_over_two_devices_equals_one_call():
    """``make_mesh_predict`` over ``[cpu, cpu]``, one program a device: each
    half of the batch on its device, gathered on the first; the coordinates
    equal one call's bit for bit, the confidences to float32 rounding."""
    from tests.test_torch_port_models import model_pair

    from dahpe_tpu_torch import serving
    from dahpe_tpu_torch.evaluate import PredictProgram

    _, _, model = model_pair("basic", image_size=IMAGE, seed=2)
    net = serving._ServingNet(model)
    devices = ["cpu", "cpu"]
    programs = [PredictProgram(lambda w, x: torch.func.functional_call(net, w, (x,)),
                               image_size=IMAGE, heatmap_size=HM, device=d) for d in devices]
    program = programs[0]
    weights = serving.serving_weights(model)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, IMAGE, IMAGE, 3)).astype(np.float32))
    mesh = serving.make_mesh_predict(programs, devices)
    with torch.no_grad():
        coords, maxvals = program(weights, x)
        got = mesh(weights, x)
        again = mesh(weights, x)  # the weights stay placed
    assert torch.equal(got[0], coords) and torch.equal(again[0], coords)
    np.testing.assert_allclose(got[1], maxvals, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="split"):
        mesh(weights, x[:3])


def test_steps_per_call_under_gloo_on_a_card_is_refused(tmp_path, monkeypatch):
    """Gloo's collectives cannot be captured in a CUDA graph: a chunked run
    on a card under gloo with more than one rank is refused before
    anything is built (the argument path only)."""
    from dahpe_tpu_torch.cli import train as train_cli

    monkeypatch.setenv("DAHPE_NUM_PROCESSES", "2")
    monkeypatch.setenv("DAHPE_DIST_BACKEND", "gloo")
    argv = _cli_argv(("rhd", "h3d"), tmp_path / "logs", "--steps-per-call", "2",
                     "--max-steps", "4")[3:]
    argv[argv.index("cpu")] = "cuda"
    with pytest.raises(SystemExit, match="gloo"):
        train_cli.cli_main(argv)
    assert not os.path.exists(tmp_path / "logs")


def test_cross_rank_bn_on_two_ranks_matches_one_process(setup):
    """Each rank's rows against one process's BatchNorm2d on the
    concatenated batch: outputs, running statistics and the ranks' averaged
    weight and bias gradients equal the single process's within atol 1e-5;
    each rank's input gradient is W times the global loss's (its loss is a
    mean over its own rows)."""
    x, g = setup["inputs"]["bn_x"], setup["inputs"]["bn_g"]
    one = bn_case(x, g)
    for r, res in enumerate(setup["ranks"]):
        got = res["bn"]
        np.testing.assert_allclose(got["y"], _rows(one["y"], r), atol=1e-5)
        np.testing.assert_allclose(got["dx"], WORLD * _rows(one["dx"], r), atol=1e-5)
        for k in ("dweight", "dbias", "running_mean", "running_var"):
            np.testing.assert_allclose(got[k], one[k], atol=1e-5, err_msg=k)
        assert int(got["num_batches_tracked"]) == 1


@pytest.mark.parametrize("gate", GATES, ids=["gate-off", "gate-0.5"])
def test_da_step_on_two_ranks_matches_one_process(setup, gate):
    """Two DA iterations on 2 gloo ranks against the single-process step on
    the same global batches: every iteration's losses and accuracies within
    rel 1e-4, every parameter and BN statistic within 1e-4, both ranks
    equal. With the gate at 0.5 this holds only because the quantile is
    the global batch's."""
    batches = [(_to_torch(s), _to_torch(t)) for s, t in setup["inputs"]["da_batches"]]
    one = da_steps(setup["inputs"]["da_weights"], batches, gate, None)
    ranks = [res[f"da_{gate}"] for res in setup["ranks"]]
    for got in ranks:
        for m_got, m_one in zip(got["metrics"], one["metrics"]):
            for k, v in m_one.items():
                np.testing.assert_allclose(m_got[k], v, rtol=1e-4, err_msg=k)
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=1e-4, rtol=0, err_msg=k)
    assert all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in one["state"])


def _bn_gap(got, want):
    """The worst |got - want| over every BN running statistic, and where."""
    gaps = {k: float((got[k].double() - want[k].double()).abs().max())
            for k in want if k.endswith(("running_mean", "running_var"))}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def _world_one(inputs, **kw):
    batches = [(_to_torch(s), _to_torch(t)) for s, t in inputs["da_batches"]]
    return da_steps(inputs["da_weights"], batches, None, None, **kw)


def test_cross_rank_bn_formula_on_a_one_rank_group(jobs):
    """The BN-statistics gap classified, part 1: the cross-rank layer forced
    on a process group of ONE rank (its own gloo group, in a subprocess)
    against ``nn.BatchNorm2d``'s, two DA iterations at mini depth on the
    same weights and batches. This is the formula ``E[x²] - E[x]²`` and the
    autograd function alone, without a split batch. Criterion (PERF.md
    §6): a fault if the gap is above 2x the float32 rounding of the
    same world-1 run, its distance to the float64 run."""
    jobs["one_rank"].wait()
    forced = torch.load(jobs["one_rank_out"], weights_only=False)["da"]["state"]
    f32 = _world_one(jobs["inputs"])["state"]
    f64 = _world_one(jobs["inputs"], dtype=torch.float64)["state"]
    gap, at = _bn_gap(forced, f32)
    rounding, at64 = _bn_gap(f32, f64)
    msg = (f"forced cross-rank BN on 1 rank vs nn.BatchNorm2d: {gap:.3g} ({at}); "
           f"world-1 float32 vs float64: {rounding:.3g} ({at64})")
    print(msg)
    assert gap <= 2 * rounding, msg


def test_bn_statistics_gap_of_two_ranks_is_within_jax_s_own(jobs, setup):
    """The BN-statistics gap classified, part 2: 2 gloo ranks against world
    1 on the same weights and global batches (two DA iterations at mini
    depth), beside the JAX package's own ``batch_stats`` gap between 1 and
    2 virtual CPU devices (``tests/conftest.py``) on the same inputs. The
    port's gap must stay within 2x the larger of JAX's and the world-1
    float32-vs-float64 distance (the criterion of PERF.md §6)."""
    one = _world_one(jobs["inputs"])["state"]
    f64 = _world_one(jobs["inputs"], dtype=torch.float64)["state"]
    port_gap, port_at = _bn_gap(setup["ranks"][0]["da_None"]["state"], one)
    j1 = state_dict_from_jax(jax_parallel_run(jobs, 1, None)[1])
    j2 = state_dict_from_jax(jax_parallel_run(jobs, WORLD, None)[1])
    jax_gap, jax_at = _bn_gap(j2, j1)
    rounding, _ = _bn_gap(one, f64)
    msg = (f"BN statistics, 2 ranks vs world 1: port {port_gap:.3g} ({port_at}), "
           f"JAX 2 vs 1 devices {jax_gap:.3g} ({jax_at}), port world-1 float32 vs "
           f"float64 {rounding:.3g}")
    print(msg)
    assert port_gap <= 2 * max(jax_gap, rounding), msg


def test_pretrain_step_on_two_ranks_matches_one_process(setup):
    one = pretrain_step(setup["inputs"]["pretrain_weights"],
                        _to_torch(setup["inputs"]["pretrain_batch"]), None)
    for res in setup["ranks"]:
        got = res["pretrain"]
        np.testing.assert_allclose(got["loss_s"], one["loss_s"], rtol=1e-4)
        np.testing.assert_allclose(got["acc_s"], one["acc_s"], rtol=1e-4)
        for k, v in one["state"].items():
            np.testing.assert_allclose(got["state"][k], v, atol=1e-4, rtol=0, err_msg=k)


def test_parallel_eval_step_gathers_the_global_heatmaps(setup):
    """Each rank's eval step runs its rows and gathers every rank's
    heatmaps: the global batch's, and the same PCK as one process."""
    from dahpe_tpu_torch.core.metrics import pck_accuracy
    from dahpe_tpu_torch.evaluate import _eval_forward

    model = _mini_model()
    model.load_state_dict(setup["inputs"]["da_weights"])
    b_s = setup["inputs"]["da_batches"][0][0]
    with torch.inference_mode():
        one = _eval_forward(model, torch.from_numpy(b_s["image"]))
    target = torch.from_numpy(b_s["target"])
    for res in setup["ranks"]:
        got = res["eval_heatmaps"]
        assert got.shape == one.shape
        np.testing.assert_allclose(got, one, atol=1e-5)
        assert float(pck_accuracy(got, target)[1]) == float(pck_accuracy(one, target)[1])


def test_stop_consensus_drains_both_ranks_at_one_step(setup):
    """Rank 1 alone is signalled during step 3; with the poll every 2 steps
    (``--print-freq 2``) both ranks stop after step 4."""
    assert [res["stop_step"] for res in setup["ranks"]] == [4, 4]


def test_replicate_and_state_helpers_on_two_ranks(setup):
    """``replicate`` gives rank 1 rank 0's weights back (``assert_replicated``
    then passes on both, over every parameter and buffer); the sidecar's
    gathered stream states hold one row a rank, which ``rank_stream_state``
    hands back to its rank at the same world size and to no rank at
    another; ``create_mesh`` lists each rank's device."""
    from dahpe_tpu_torch.utils import checkpoint as ckpt

    n = len(_mini_model().state_dict())
    ranks = setup["ranks"]
    assert [res["replicated"] for res in ranks] == [n, n]
    gathered = ranks[0]["gathered_states"]
    assert torch.equal(gathered, ranks[1]["gathered_states"])
    for r, res in enumerate(ranks):
        assert torch.equal(gathered[r], res["gen_state"])
        assert np.array_equal(ckpt.rank_stream_state(gathered.numpy(), r, WORLD),
                              res["gen_state"].numpy())
        assert ckpt.rank_stream_state(gathered.numpy(), r, 4) is None
        assert res["mesh"] == ["cpu", "cpu"]
    assert not torch.equal(ranks[0]["gen_state"], ranks[1]["gen_state"])


def test_cli_multihost_two_ranks_resume_equals_straight_run(jobs):
    """``cli.train --multihost --device cpu --device-store`` on 2 gloo ranks:
    every run exits 0 and only rank 0 wrote (rank 1's log directory does
    not exist); ``--max-steps 2`` then ``--resume`` to 4, where only rank 0
    reads the checkpoint, equals a straight 4-step run bit for bit,
    weights, momentum, step and each rank's sampling states included."""
    from dahpe_tpu_torch.utils import checkpoint as ckpt
    from dahpe_tpu_torch.utils import fast_ckpt

    root = jobs["root"]
    jobs["cli"]["cut"].wait()
    resumed = _cli_job(jobs["roots"], root, "cut", "--max-steps", "4", resume=True)
    out0 = resumed.wait()[0]
    jobs["cli"]["straight"].wait()
    assert "resumed from" in out0 and "(with stream keys)" in out0
    for name in ("straight", "cut"):
        assert os.path.isdir(root / f"{name}_0" / "checkpoints")
        assert not os.path.exists(root / f"{name}_1")
    cut = str(root / "cut_0" / "checkpoints" / "latest")
    straight = str(root / "straight_0" / "checkpoints" / "latest")
    flat_c = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(cut))
    flat_s = fast_ckpt.flatten_tree(fast_ckpt.load_packed_tree(straight))
    assert [p for p, _ in flat_c] == [p for p, _ in flat_s]
    for (path, a), (_, b) in zip(flat_c, flat_s):
        assert torch.equal(a, b), "/".join(path)
    aux_c, aux_s = ckpt.load_aux(cut), ckpt.load_aux(straight)
    for k in ("key_s", "key_t"):
        assert aux_c[k].shape[0] == WORLD and np.array_equal(aux_c[k], aux_s[k])
