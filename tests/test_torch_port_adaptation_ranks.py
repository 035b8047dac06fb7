"""PyTorch port, the adaptation experiment over W ranks
(``run_adaptation_experiment(n_devices=W)``) on the CPU, at ``micro``
depth and 64²/16², 2 + 2 + 2 iterations (pretrain, control, DA), global
batch 4 from 8 frames a domain.

The JAX experiment's threefry draws cannot be replayed in torch, so its
W-device run cannot be reproduced draw for draw. The comparison with JAX
is therefore: the rank-count rule against JAX's formula (below); the
store shard assignment
(``tests/test_torch_port_parallel.py::test_store_shards_follow_the_jax_assignment``);
the result's keys; and the step-level parity of
``::test_da_step_on_two_ranks_matches_jax_data_parallel_step``. Here:

- 2 gloo ranks started by ``parallel.run_ranks`` against one process on
  the same global draws (:func:`global_draws`: every rank draws the whole
  global batch from one stream and keeps the rows JAX's shard assignment
  gives it): pretrain and control losses rel 1e-4, the DA and EMA states
  at the DA parity tolerance (rtol 5e-3, atol 5e-5,
  ``tests/test_da_parity.py:221-223``), one result on both ranks with
  every key;
- the experiment as a rank of a 2-rank group the caller brought up
  (processes of this file run as a script: torch and the port only): it
  spawns nothing, and an ``n_devices`` that gives another count is a
  ``ValueError``;
- the launcher: a rank that raises, or a launch past its timeout, raises
  in the caller and leaves no live child;
- ``n_devices=1`` and ``None`` on the CPU spawn nothing, bring up no group
  and equal the default call bit for bit.
"""

import math
import multiprocessing
import os
import sys
import time

import numpy as np
import pytest
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    sys.path.insert(0, REPO_ROOT)

WORLD = 2
EXPERIMENT = dict(arch="micro", n_train=8, n_val=8, batch=4, pre_iters=2, da_iters=2,
                  eval_every=1, conf_gate=0.5, shift=0.3, content=0.3, style=1.0, seed=1,
                  device="cpu", verbose=False)
LOSSES = ("loss_s", "loss_gf", "loss_gt")


# --------------------------------------------------------------------------
# seams and rank bodies: torch and the port only (spawned ranks import this
# module, and the group job runs it as a script)
# --------------------------------------------------------------------------

def global_draws(world, setattr=setattr):
    """Make every ``DeviceDataStore`` of this process draw the global batch
    of a ``world``-rank job and keep its own rows: ``batch / world`` row
    indices from each of the ``world`` equal parts of the store's rows (JAX's
    shard assignment), then the augmentation draws of the whole batch, all
    from the one generator, which no rank folds its rank into. A store of
    every row keeps the whole batch; rank r's shard keeps the rows of part
    r. One process and the ranks then see the same global batches."""
    from dahpe_tpu_torch.data.device_aug import draw_augment_params
    from dahpe_tpu_torch.data.device_store import DeviceDataStore

    def traced_batch_fn(self, batch_size, *, image_size=256, heatmap_size=64, rotation=180.0,
                        scale_range=(0.6, 1.3), sigma=2.0):
        rows, part = batch_size // world, self.n * self.world // world
        mine = slice(self.rank * batch_size // self.world,
                     (self.rank + 1) * batch_size // self.world)
        cfg = dict(image_size=image_size, heatmap_size=heatmap_size, sigma=sigma)

        def produce(generator):
            idx = torch.cat([torch.randperm(part, generator=generator, device=self.device)[:rows]
                             + part * r for r in range(world)])
            params = draw_augment_params(generator, batch_size, size=self.raw_size,
                                         rotation=rotation, scale_range=tuple(scale_range))
            return self.train_batch_from(idx[mine] - self.n * self.rank,
                                         {k: v[mine] for k, v in params.items()}, **cfg)

        return produce

    setattr(DeviceDataStore, "traced_batch_fn", traced_batch_fn)
    setattr(DeviceDataStore, "_seed", lambda self, seed: int(seed))


def record(into, setattr=setattr):
    """Record into ``into`` the losses of every fused iteration the
    experiment runs (``pretrain``: pretrain and control, ``da``) and the
    state dicts of the last two models it evaluates (the DA model and its
    EMA twin)."""
    from dahpe_tpu_torch import train
    from dahpe_tpu_torch.experiments import adaptation

    into.update(pretrain=[], da=[], evaluated=[])
    real_pre, real_da = train.make_fused_pretrain_iteration, train.make_fused_da_iteration
    real_eval = adaptation._eval_target

    def pretrain(*a, **kw):
        call = real_pre(*a, **kw)

        def run(*args):
            out = call(*args)
            into["pretrain"].append(float(out[1]["loss_s"]))
            return out
        return run

    def da(*a, **kw):
        call = real_da(*a, **kw)

        def run(*args):
            out = call(*args)
            into["da"].append({k: float(out[1][k]) for k in LOSSES})
            return out
        return run

    def evaluated(model, *a, **kw):
        into["evaluated"] = into["evaluated"][-1:] + [
            {k: v.detach().clone() for k, v in model.state_dict().items()}]
        return real_eval(model, *a, **kw)

    setattr(train, "make_fused_pretrain_iteration", pretrain)
    setattr(train, "make_fused_da_iteration", da)
    setattr(adaptation, "_eval_target", evaluated)


def ranked_experiment(**kw):
    """One rank of the parity job: the seams, then the experiment as this
    rank of the group. Rank 0 returns every rank's result and losses and
    its own last two evaluated states."""
    import torch.distributed as dist

    from dahpe_tpu_torch import parallel
    from dahpe_tpu_torch.experiments import adaptation

    torch.set_num_threads(1)
    global_draws(parallel.world_size())
    seen = {}
    record(seen)
    result = adaptation.run_adaptation_experiment(n_devices=parallel.world_size(), **kw)
    mine = {"result": result, "pretrain": seen["pretrain"], "da": seen["da"]}
    everyone = [None] * parallel.world_size()
    dist.all_gather_object(everyone, mine)
    return {"ranks": everyone, "evaluated": seen["evaluated"]}


def failing_rank(fail_rank):
    """Rank ``fail_rank`` raises; the others wait for it in a barrier."""
    from dahpe_tpu_torch import parallel

    if parallel.rank() == fail_rank:
        raise ValueError(f"rank {fail_rank} fails on purpose")
    parallel.barrier()


def sleeping_rank(seconds):
    time.sleep(seconds)


def _group_worker(port, rank, out):
    """One rank of a 2-rank group this process brings up itself (the
    ``DAHPE_*`` contract): an ``n_devices`` that gives 4 ranks, then the
    experiment at ``n_devices=None``, with every way to spawn patched to
    raise."""
    import torch.multiprocessing as mp

    from dahpe_tpu_torch import parallel
    from dahpe_tpu_torch.experiments import adaptation

    os.environ.update(DAHPE_COORDINATOR=f"127.0.0.1:{port}", DAHPE_NUM_PROCESSES=str(WORLD),
                      DAHPE_PROCESS_ID=rank, DAHPE_DIST_INIT_TIMEOUT="60")
    torch.set_num_threads(1)
    parallel.robust_distributed_initialize("cpu")

    def spawn(*a, **kw):
        raise AssertionError("the experiment spawned inside a group")

    parallel.run_ranks = mp.start_processes = spawn
    try:
        adaptation.run_adaptation_experiment(**{**EXPERIMENT, "n_devices": 4})
        refused = None
    except ValueError as err:
        refused = str(err)
    result = adaptation.run_adaptation_experiment(**{**EXPERIMENT, "n_devices": None})
    torch.save({"refused": refused, "result": result,
                "children": len(multiprocessing.active_children())}, out)
    parallel.shutdown()


if __name__ == "__main__":
    _group_worker(*sys.argv[1:])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

from dahpe_tpu_torch import parallel  # noqa: E402
from dahpe_tpu_torch.experiments import adaptation  # noqa: E402


def _result_keys():
    from tests.test_torch_port_adaptation import RESULT_KEYS

    return RESULT_KEYS


def _no_spawn(monkeypatch):
    """Make every way the experiment could start a rank raise."""
    import torch.multiprocessing as mp

    def spawn(*a, **kw):
        raise AssertionError("spawned a rank")

    monkeypatch.setattr(parallel, "run_ranks", spawn)
    monkeypatch.setattr(mp, "start_processes", spawn)


@pytest.fixture(scope="module", autouse=True)
def group_job(tmp_path_factory):
    """The existing-group job, started with the module (its ranks run while
    the other tests do)."""
    from tests.test_torch_port_parallel import Ranks, _free_port

    root = tmp_path_factory.mktemp("adaptation_group")
    port = _free_port()
    outs = [str(root / f"rank{r}.pt") for r in range(WORLD)]
    job = Ranks([[sys.executable, __file__, str(port), str(r), outs[r]] for r in range(WORLD)])
    yield job, outs
    job.kill()


@pytest.fixture(scope="module")
def one_process():
    """The default call in this process (n_devices left at its default),
    recorded."""
    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        record(seen, mp.setattr)
        seen["result"] = adaptation.run_adaptation_experiment(**EXPERIMENT)
    return seen


@pytest.mark.parametrize("batch,n_devices,available", [
    (32, None, 1), (32, None, 4), (32, None, 8), (32, None, 3), (32, 1, 8), (32, 2, 1),
    (32, 4, 8), (32, 3, 8), (32, 12, 8), (4, 8, 8), (6, 4, 1), (15, None, 8), (1, None, 8)])
def test_rank_count_is_jax_s_rule(batch, n_devices, available):
    """``rank_count`` against the JAX experiment's own line, with
    ``len(jax.devices())`` standing for the devices available: ``None``
    takes them all, a non-divisor of the batch falls to the gcd, 1 stays
    1."""
    import inspect

    from dahpe_tpu.experiments import adaptation as jax_adaptation

    assert "n_dev = math.gcd(batch, n_devices or len(jax.devices()))" in inspect.getsource(
        jax_adaptation.run_adaptation_experiment)
    assert adaptation.rank_count(batch, n_devices, available) == \
        math.gcd(batch, n_devices or available)


def test_available_devices_on_the_cpu_is_one():
    assert adaptation.available_devices("cpu") == 1


def test_two_ranks_through_the_launcher_match_one_process(monkeypatch):
    """2 gloo ranks through ``parallel.run_ranks`` against one process (one
    thread, as each rank), both on the global draws of a 2-rank job: the
    pretrain and control losses rel 1e-4, the DA and EMA states at the DA
    parity tolerance, one result with every key on both ranks. The DA
    losses are not compared: at this size the random model's heatmaps are
    nearly flat, and a pseudo-label peak can flip on rounding alone (the
    one process at 2 or 4 threads moved the second iteration's ``loss_gf``
    by 0.7% while the states stayed within half the tolerance)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ranks = parallel.run_ranks(ranked_experiment, WORLD, device="cpu", kwargs=EXPERIMENT)
    want, threads = {}, torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            global_draws(WORLD, mp.setattr)
            record(want, mp.setattr)
            want["result"] = adaptation.run_adaptation_experiment(n_devices=1, **EXPERIMENT)
    finally:
        torch.set_num_threads(threads)
    results = [r["result"] for r in ranks["ranks"]]
    assert results[0] == results[1]
    assert set(results[0]) == _result_keys()
    for res in ranks["ranks"]:
        assert len(res["pretrain"]) == 4 and len(res["da"]) == 2
        np.testing.assert_allclose(res["pretrain"], want["pretrain"], rtol=1e-4)
    for got, exp in zip(ranks["evaluated"], want["evaluated"], strict=True):
        assert set(got) == set(exp)
        for key, value in exp.items():
            np.testing.assert_allclose(got[key].double().numpy(), value.double().numpy(),
                                       rtol=5e-3, atol=5e-5, err_msg=key)


def test_experiment_runs_as_a_rank_of_an_existing_group(group_job):
    """In a 2-rank group the caller brought up, the experiment runs as this
    process's rank and spawns nothing; ``n_devices=4`` at batch 4 gives 4
    ranks, a ``ValueError`` that names 4 and 2."""
    job, outs = group_job
    job.wait()
    got = [torch.load(o, weights_only=False) for o in outs]
    for res in got:
        assert res["children"] == 0
        assert "gives 4 ranks" in res["refused"] and "has 2" in res["refused"]
    assert got[0]["result"] == got[1]["result"]
    assert set(got[0]["result"]) == _result_keys()


@pytest.mark.parametrize("case", ["raises", "times_out"])
def test_failed_launch_raises_and_leaves_no_child(case, monkeypatch):
    """A rank that raises makes ``run_ranks`` raise with that rank's
    traceback (not the one of the rank its exit broke); a launch past its
    timeout raises ``TimeoutError``. Neither leaves a child alive."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    if case == "raises":
        with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 raised.*rank 1 fails on purpose"):
            parallel.run_ranks(failing_rank, WORLD, device="cpu", kwargs={"fail_rank": 1})
    else:
        with pytest.raises(TimeoutError):
            parallel.run_ranks(sleeping_rank, WORLD, device="cpu", kwargs={"seconds": 600},
                               timeout=5)
    assert multiprocessing.active_children() == []


def test_too_few_cards_raise_before_any_rank_starts(monkeypatch):
    """Two NCCL ranks on a host with one card: the ``RuntimeError`` of
    ``rank_device``, before any rank starts; no fewer ranks, no CPU."""
    import torch.multiprocessing as mp

    monkeypatch.delenv("DAHPE_DIST_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(mp, "start_processes", lambda *a, **kw: pytest.fail("started a rank"))
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks on one device"):
        parallel.run_ranks(sleeping_rank, WORLD, device="cuda", kwargs={"seconds": 0})


@pytest.mark.parametrize("n_devices", [1, None])
def test_one_device_runs_in_this_process(n_devices, one_process, monkeypatch):
    """``n_devices=1`` and ``None`` on the CPU spawn nothing, bring up no
    group, and equal the default call bit for bit: every result key but
    ``da_seconds``, every loss, and the DA and EMA states."""
    import torch.distributed as dist

    _no_spawn(monkeypatch)
    seen = {}
    record(seen, monkeypatch.setattr)
    result = adaptation.run_adaptation_experiment(**{**EXPERIMENT, "n_devices": n_devices})
    assert not dist.is_initialized()
    want = one_process["result"]
    assert {k: v for k, v in result.items() if k != "da_seconds"} == \
        {k: v for k, v in want.items() if k != "da_seconds"}
    assert seen["pretrain"] == one_process["pretrain"] and seen["da"] == one_process["da"]
    for got, exp in zip(seen["evaluated"], one_process["evaluated"], strict=True):
        assert all(torch.equal(got[k], v) for k, v in exp.items())
