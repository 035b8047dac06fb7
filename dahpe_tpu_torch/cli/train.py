"""DA training CLI: ``python -m dahpe_tpu_torch.cli.train``.

Port of ``dahpe_tpu/cli/train.py`` (flow of the reference's ``train1.py:
37-275``): datasets and loaders, the model (and its EMA twin), a supervised
source pretrain when no pretrain checkpoint is given, then epochs of the
3-step minimax with per-epoch validation (and EMA validation), packed
checkpoints, a best copy, a graceful stop on SIGTERM/SIGINT and a
``--resume`` that continues the run where it stopped. One process drives one
device (``--device``, default ``cuda``).

``--multihost`` runs W processes as one data-parallel job (the
``DAHPE_*`` environment contract of ``parallel/distributed.py``, or
``torchrun``'s): each rank drives its own device and holds ``batch / W``
rows of the global batch (its shard of each store, or of each epoch of the
host loaders), batch norm takes global statistics and every SGD step
averages the gradients over the ranks, so parameters, momentum and EMA stay
equal on every rank. Rank 0 alone reads the warm start or the resume point
(and broadcasts it), logs, prints and writes checkpoints; the sidecar holds
every rank's sampling states. Validation runs on every rank over the whole
split.

Input modes of the DA loop: ``pil`` (host PIL transforms, targets on the
device), ``raw`` (``--device-aug``: host decode only, augmentation on the
device through the rotation kernel), ``warped`` (``--host-warp``: the
native library's fused warp and photometrics on the host, targets on the
device) and ``--device-store`` (the fused
iteration: gather, augmentation, targets and the step from device-resident
data, no host traffic).

``--steps-per-call K`` (with ``--device-store``) runs K iterations per
fused call, a CUDA graph replayed K times on the card; the loops then step
by K, print chunk means and stop, save and resume only on chunk boundaries.

``--bf16`` computes in bfloat16 on float32 parameters (every model the run
builds). ``--debug`` draws the first source and target image of every
printed batch with its predictions, and the target validation's host
batches, into ``{log}/visualize/`` (cv2); with ``--device-store`` it needs
one iteration a call, whose batches the fused call returns.

Deliberate divergences from the JAX package's CLI: ``--steps-per-call`` is
checked before anything runs on every input mode, and a K below 1 is
rejected, not coerced; the stop poller's cadence counts steps, not calls;
``--host-warp`` raises with the compiler's error when its native library
does not build, where the JAX package falls back to numpy.
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import random
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from dahpe_tpu_torch import parallel
from dahpe_tpu_torch.cli.args import build_parser
from dahpe_tpu_torch.cli.common import (
    build_datasets,
    build_device_val_loader,
    build_loaders,
    build_model,
    build_train_loader,
    build_val_loader,
    check_world,
    make_visualizer,
    maybe_decoded_cache,
    train_loader_mode,
    validate_steps_per_call,
)
from dahpe_tpu_torch.data import ForeverIterator, finalize_batch
from dahpe_tpu_torch.data.pipeline import device_prefetch, device_train_batch
from dahpe_tpu_torch.evaluate import make_eval_step, validate
from dahpe_tpu_torch.train import (
    create_da_state,
    create_pretrain_state,
    make_da_train_step,
    make_fused_da_iteration,
    make_fused_pretrain_iteration,
    make_pretrain_step,
)
from dahpe_tpu_torch.train.ema import ema_state
from dahpe_tpu_torch.train.optim import pretrain_lr_factor
from dahpe_tpu_torch.utils import checkpoint as ckpt
from dahpe_tpu_torch.utils import fast_ckpt
from dahpe_tpu_torch.utils.logging import RunLogger
from dahpe_tpu_torch.utils.meters import AverageMeter, ProgressMeter
from dahpe_tpu_torch.utils.torch_import import filtered_update

DA_LOSSES = ("loss_s", "loss_gf", "loss_gt")


class DivergenceError(RuntimeError):
    """Training produced a non-finite loss (exit code 3)."""


def host_scalars(metrics: dict, keys) -> dict[str, float]:
    """The named metric scalars as host floats, in one device→host copy."""
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in keys]).cpu()
    return {k: float(v) for k, v in zip(keys, vals)}


def check_finite(saver, logger, state, step: int, **losses) -> None:
    """NaN watchdog: a non-finite loss aborts the run (exit 3) instead of
    training garbage for the rest of the schedule.

    Checked at every ``--print-freq`` display (the loop fetches metrics only
    there) and before every checkpoint write, so no persisted checkpoint can
    hold a diverged state. The poisoned state goes to
    ``checkpoints/nan_abort`` for forensics; ``checkpoints/latest`` keeps its
    last finite contents, so ``--resume checkpoints/latest`` (perhaps with a
    lower lr) restarts from good weights."""
    bad = {k: v for k, v in losses.items() if not math.isfinite(v)}
    if not bad:
        return
    path = logger.get_checkpoint_path("nan_abort")
    saver.save(path, ckpt.state_tree(state))
    saver.flush()
    raise DivergenceError(
        f"non-finite losses at step {step}: "
        + ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
        + f"; diverged state dumped to {path}; every checkpoint write is "
        "finiteness-gated, so checkpoints/latest still holds the last "
        "pre-divergence state — resume from it (consider a lower --lr)"
    )


def stream_seed(seed: int, step: int, stream: int) -> int:
    """Seed of sampling stream ``stream`` (0 source store, 1 target store,
    2 the host-fed augmentation draws) for a run at ``step``: a resumed run
    without saved generator states starts new streams instead of replaying
    the ones it trained on (one with them continues those exactly)."""
    return int(np.random.SeedSequence((seed, step, stream)).generate_state(1, np.uint64)[0])


def make_stop_poller(stop_signum, every: int = 1):
    """Graceful-stop check, ``poll(step) -> signum | None``, called by every
    rank once per iteration (or chunk) with the steps done so far.

    One process answers with its local flag at every call. Ranks must agree
    on the step they drain at (the drain gathers the sampling states, a
    collective), and a signal can reach them on either side of an iteration
    boundary, so with several ranks the local flags are MAX-all-reduced
    every ``every`` steps (``--print-freq``, where the host reads the
    metrics anyway); between those steps a local flag waits. The cadence
    counts steps, so at ``--steps-per-call K`` it falls on chunk boundaries."""
    world = parallel.world_size()

    def poll(step: int) -> int | None:
        local = stop_signum[0] if stop_signum else 0
        if world == 1:
            return local or None
        if step % max(every, 1):
            return None
        flag = torch.tensor([local], dtype=torch.int64,
                            device=parallel.distributed.collective_device())
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return int(flag) or None

    return poll


def _host_batches(args, loader, finalize):
    """Finalized batches of ``loader`` forever, the next ones' host→device
    copies overlapping the current step."""
    return device_prefetch(ForeverIterator(lambda: iter(loader)), finalize, device=args.device)


def _finalize_pil(args):
    return lambda host: finalize_batch(
        host, heatmap_size=(args.heatmap_size,) * 2, image_size=(args.image_size,) * 2,
        device=args.device)


def pretrain_phase(args, logger, train_source_loader, val_source_loader,
                   val_source_dataset, *, source_store=None, saver=None,
                   stop=lambda: None):
    """Supervised source pretraining (``train1.py:158-181``).

    With ``source_store`` the batches come from device memory through the
    fused iteration (sampling generator seeded ``args.seed + 7``,
    ``--steps-per-call`` iterations a call); otherwise the host PIL loader
    feeds the step. ``stop()`` is polled at every
    iteration boundary: on a stop the model lands in
    ``checkpoints/pretrain_interrupt`` and the function returns None (the
    caller exits 0; a later run continues with ``--pretrain`` on that path).
    Returns the path of the best-validating pretrain checkpoint.
    """
    model = build_model(args, multi_head=False)
    state = create_pretrain_state(model, device=args.device, momentum=args.momentum,
                                  weight_decay=args.wd)
    if args.imagenet_pth and parallel.rank() == 0:
        ckpt.load_imagenet_backbone(args.imagenet_pth, model)
    hyper = dict(momentum=args.momentum, weight_decay=args.wd)
    parallel.replicate(model)  # rank 0's weights on every rank (nothing without a group)
    hyper.update(parallel.data_parallel(model))
    chunk = validate_steps_per_call(args) if source_store is not None else 1
    if source_store is not None:
        fused = make_fused_pretrain_iteration(
            model, source_store, args.batch_size, image_size=args.image_size,
            heatmap_size=args.heatmap_size, rotation=args.rotation,
            scale_range=tuple(args.resize_scale), steps_per_call=chunk, **hyper,
        )
        gen = source_store.generator(args.seed + 7)

        def run_iteration(state, lr):
            state, metrics, _ = fused(state, gen, lr)
            return state, metrics
    else:
        step_fn = make_pretrain_step(model, **hyper)
        batches = _host_batches(args, train_source_loader, _finalize_pil(args))

        def run_iteration(state, lr):
            return step_fn(state, next(batches), lr)
    eval_step = make_eval_step(model, device=args.device)
    pretrain_path = logger.get_checkpoint_path("pretrain")
    # the reference starts at 0 (train1.py:165) and would never write the
    # checkpoint if val acc stayed <= 0; -inf guarantees a checkpoint exists
    best_acc = float("-inf")

    for epoch in range(args.pretrain_epochs):
        lr = args.lr * pretrain_lr_factor(epoch, milestones=tuple(args.lr_step),
                                          factor=args.lr_factor)
        print(f"pretrain epoch {epoch} lr {lr:.2e}")
        batch_time = AverageMeter("Time", ":4.2f")
        losses = AverageMeter("Loss (s)", ":.2e")
        accs = AverageMeter("Acc (s)", ":3.2f")
        progress = ProgressMeter(args.iters_per_epoch, [batch_time, losses, accs],
                                 prefix=f"Epoch: [{epoch}]")
        end = time.time()
        for i in range(0, args.iters_per_epoch, chunk):
            state, metrics = run_iteration(state, lr)
            step = epoch * args.iters_per_epoch + i
            if i % args.print_freq == 0:
                vals = host_scalars(metrics, ("loss_s", "acc_s"))
                check_finite(saver, logger, state, step, loss_s=vals["loss_s"])
                losses.update(vals["loss_s"])
                accs.update(vals["acc_s"])
                batch_time.update(time.time() - end)
                progress.display(i)
            end = time.time()
            signum = stop(step + chunk)
            if signum is not None:
                path = logger.get_checkpoint_path("pretrain_interrupt")
                check_finite(saver, logger, state, step, **host_scalars(metrics, ("loss_s",)))
                saver.save(path, ckpt.model_tree(model))
                saver.flush()
                print(f"signal {signum}: finished the in-flight iteration, saved {path}, "
                      f"exiting cleanly — continue with --pretrain {path}")
                return None

        acc = validate(val_source_loader, model, val_source_dataset,
                       image_size=args.image_size, heatmap_size=args.heatmap_size,
                       print_freq=args.print_freq, eval_step=eval_step, device=args.device)
        if acc["all"] > best_acc:
            best_acc = acc["all"]
            # drains behind the next epoch's compute; flushed below
            saver.save(pretrain_path, ckpt.model_tree(model))
        print(f"Source: {acc['all']:.4f} best: {best_acc:.4f}")
        logger.log_metrics(kind="pretrain_epoch", epoch=epoch, lr=lr, loss_s=losses.avg,
                           acc_s=accs.avg, iter_time_s=batch_time.avg, val_source=acc,
                           best_source=best_acc)
    saver.flush()  # the DA phase loads pretrain_path right away
    return pretrain_path


def main(args):
    # argument contract first: failing after the dataset build and upload
    # would waste minutes on a usage error
    validate_steps_per_call(args)
    started_group = False
    if args.multihost:
        # bring-up is timeout-bounded and retried (parallel/distributed.py);
        # each rank then runs on its own device
        started_group = not dist.is_initialized()
        args.device = str(parallel.robust_distributed_initialize(args.device))
        check_world(args, parallel.world_size())
    primary = parallel.rank() == 0
    quiet = None
    if not primary:  # rank 0 alone prints; errors still reach stderr
        quiet, sys.stdout = sys.stdout, open(os.devnull, "w")
    logger = RunLogger(args.log, args.phase, primary=primary)
    # checkpoint writes drain on a worker thread behind the next epoch's
    # compute (utils/fast_ckpt.py); rank 0 alone writes
    saver = fast_ckpt.AsyncSaver() if primary else _NoSaver()

    # Preemption contract (the reference has none): SIGTERM/SIGINT request a
    # graceful stop; the in-flight iteration finishes, the state is
    # checkpointed and the process exits 0. Installed before the pretrain
    # phase so a long pretraining run is covered too.
    stop_signum: list[int] = []  # the handler appends; loops poll at boundaries

    def _request_stop(signum, frame):
        # flag-only: a print() here can re-enter the buffered writer the main
        # thread is inside and crash the very drain this handler protects
        if stop_signum:
            # second signal: stop being graceful (e.g. a double ctrl-C while
            # a validation sweep delays the iteration boundary)
            restore_handlers()
            signal.raise_signal(signum)
            return
        stop_signum.append(signum)

    prev_handlers = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}

    def restore_handlers():
        for s, h in prev_handlers.items():
            signal.signal(s, h)

    # tee + handlers are process-global: un-install them even when a phase
    # raises, so an escaped exception cannot leave stdout redirected
    try:
        _run_phases(args, logger, saver, stop_signum)
    finally:
        restore_handlers()
        logger.close()
        if quiet is not None:
            sys.stdout.close()
            sys.stdout = quiet
        if started_group:
            parallel.shutdown()


class _NoSaver:
    """The checkpoint writer of a rank other than 0: every write is
    rank 0's."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _load_warm_start(model, path: str) -> None:
    """``--pretrain``: a reference ``.pth`` or a packed checkpoint (the
    port's or the JAX package's), key-filtered into ``model``: backbone and
    upsampling transfer, the pretrain head's keys do not exist in the
    multi-head model and are dropped (``train1.py:184-189``)."""
    if path.endswith(".pth"):
        ckpt.load_reference_pth(path, model, strict=False)
    else:
        model.load_state_dict(filtered_update(model.state_dict(),
                                              ckpt.load_model_variables(path)))


def _run_phases(args, logger, saver, stop_signum):
    print(args)
    rank, world = parallel.rank(), parallel.world_size()
    primary = rank == 0
    random.seed(args.seed)
    np.random.seed(args.seed)

    (train_source, val_source, train_target, val_target) = build_datasets(args)
    loader_mode = train_loader_mode(args)
    if args.device_store:
        # train and val data live on the device (stores below); host val
        # loaders serve only the standalone test phase
        train_source_loader = train_target_loader = None
        val_source_loader = val_target_loader = None
        if args.phase == "test":
            val_source_loader = build_val_loader(args, val_source)
            val_target_loader = build_val_loader(args, val_target)
    else:
        (train_source_loader, val_source_loader,
         train_target_loader, val_target_loader) = build_loaders(
            args, train_source, val_source, train_target, val_target, train_mode=loader_mode)
        print("Source train:", len(train_source_loader))
        print("Target train:", len(train_target_loader))

    stores = None
    if args.phase == "train" and args.device_store:
        from dahpe_tpu_torch.data.device_store import DeviceDataStore

        stores = {}
        for name, ds in (("source", train_source), ("target", train_target)):
            stores[name] = DeviceDataStore(maybe_decoded_cache(args, ds), device=args.device,
                                           verbose=False, shard=(rank, world))
            print(f"device store ({name}): {stores[name].n} samples, "
                  f"{stores[name].nbytes() / 1e9:.2f} GB")
        val_source_loader = build_device_val_loader(args, val_source, name="source")
        val_target_loader = build_device_val_loader(args, val_target, name="target")
    if val_source_loader is not None:
        print("Source test:", len(val_source_loader))
        print("Target test:", len(val_target_loader))

    model = build_model(args, multi_head=True)
    state = create_da_state(model, device=args.device, with_ema=args.with_ema,
                            momentum=args.momentum, weight_decay=args.wd)

    start_epoch = start_iter = 0
    resume_aux = {}  # sampling-generator states + best-acc watermark
    if args.resume:
        # rank 0 reads the resume point; the others take it over the wire
        if primary:
            ckpt.restore_state(args.resume, state)
            resume_aux = ckpt.load_aux(args.resume)
        if world > 1:
            parallel.replicate(state)
            shared = [resume_aux]
            dist.broadcast_object_list(shared)
            resume_aux = shared[0]
        start_epoch = state.step // args.iters_per_epoch
        # a mid-epoch 'latest' (--save-every, --max-steps, a stop) resumes at
        # the iteration it stopped on; epoch checkpoints land on 0
        start_iter = state.step % args.iters_per_epoch
        print(f"resumed from {args.resume} at epoch {start_epoch}"
              + (f" iteration {start_iter}" if start_iter else "")
              + (" (with stream keys)" if "key_s" in resume_aux else ""))
    else:
        pretrain_path = args.pretrain
        if pretrain_path is None and args.phase == "train" and args.pretrain_epochs > 0:
            print("Pretraining the model on source domain.")
            # pretraining consumes PIL batches whatever the DA loaders' mode
            pretrain_loader = None
            if stores is None:
                pretrain_loader = (train_source_loader if loader_mode == "pil"
                                   else build_train_loader(args, train_source, mode="pil"))
            pretrain_path = pretrain_phase(
                args, logger, pretrain_loader, val_source_loader, val_source,
                source_store=stores["source"] if stores else None, saver=saver,
                stop=make_stop_poller(stop_signum, args.print_freq),
            )
            if pretrain_path is None:  # graceful stop during pretraining
                saver.close()
                return
        if pretrain_path is not None:
            if primary:  # the others take the weights over the wire
                _load_warm_start(model, pretrain_path)
            parallel.replicate(model)
            if state.ema is not None:
                state.ema = {k: v.detach().clone() for k, v in ema_state(model).items()}

    if world > 1:  # every rank checks it starts from rank 0's state
        parallel.assert_replicated(state)
    draw = args.debug and primary
    visualize = make_visualizer(train_source, logger) if draw else None
    eval_step = make_eval_step(model, device=args.device)
    val_kw = dict(image_size=args.image_size, heatmap_size=args.heatmap_size,
                  print_freq=args.print_freq, device=args.device)

    if args.phase == "test":
        src_acc = validate(val_source_loader, model, val_source, eval_step=eval_step, **val_kw)
        tgt_acc = validate(val_target_loader, model, val_target, eval_step=eval_step, **val_kw)
        print(f"Source: {src_acc['all']:4.3f} Target: {tgt_acc['all']:4.3f}")
        for name, acc in tgt_acc.items():
            print(f"{name}: {acc:4.3f}")
        logger.log_metrics(kind="eval", val_source=src_acc["all"], val_target=tgt_acc)
        saver.close()
        return

    # --- DA training ------------------------------------------------------
    chunk = validate_steps_per_call(args)
    if start_iter % chunk:
        raise SystemExit(
            f"--resume checkpoint stops at mid-epoch iteration {start_iter}, which is not "
            f"a --steps-per-call {chunk} chunk boundary: resume with the K it was saved "
            "under (or K=1)")
    step_config = dict(
        base_lr=args.lr, lr_gamma=args.lr_gamma, lr_decay=args.lr_decay,
        trade_off=args.trade_off, momentum=args.momentum, weight_decay=args.wd,
        ema_decay=args.ema_decay if args.with_ema else None,
        conf_gate=args.conf_gate or None,
    )
    step_config.update(parallel.data_parallel(model))  # one rank of the job, if any
    producer = dict(image_size=args.image_size, heatmap_size=args.heatmap_size,
                    rotation=args.rotation, scale_range=tuple(args.resize_scale))
    if args.device_store:
        # each rank's streams (a sharded store folds its rank into the seed);
        # a resume at the world size it was saved at continues them
        gens = []
        for i, (name, key) in enumerate((("source", "key_s"), ("target", "key_t"))):
            gens.append(stores[name].generator(stream_seed(args.seed, state.step, i)))
            saved = ckpt.rank_stream_state(resume_aux.get(key), rank, world)
            if saved is not None:
                gens[i].set_state(torch.from_numpy(saved))

        def current_stream_aux():  # a collective under --multihost
            return ckpt.gather_stream_states({"key_s": gens[0].get_state(),
                                              "key_t": gens[1].get_state()})

        # one call per chunk of iterations: both stores' gather +
        # augmentation + targets and the 3-step minimax, the generators
        # advancing on device; a one-iteration call (--debug's) also returns
        # its batches for the drawings
        fused = make_fused_da_iteration(model, stores["source"], stores["target"],
                                        args.batch_size, steps_per_call=chunk,
                                        **producer, **step_config)

        def run_iteration(state):
            return fused(state, gens[0], gens[1])
    else:
        step_fn = make_da_train_step(model, **step_config)
        if args.device_aug:
            # the host-fed augmentation draws: a generator on the device,
            # seeded from the step so a resumed run draws anew
            aug_gen = torch.Generator(device=args.device)
            seed = stream_seed(args.seed, state.step, 2)
            aug_gen.manual_seed(seed if world == 1 else parallel.fold_in(seed, rank))

            def finalize(host):
                return device_train_batch(host, aug_gen, **producer)
        else:
            finalize = _finalize_pil(args)
        source_batches = _host_batches(args, train_source_loader, finalize)
        target_batches = _host_batches(args, train_target_loader, finalize)

        def current_stream_aux():
            return {}

        def run_iteration(state):
            b_s, b_t = next(source_batches), next(target_batches)
            state, metrics = step_fn(state, b_s, b_t)
            return state, metrics, b_s, b_t

    # the watermark survives resume: a post-resume epoch must not overwrite
    # checkpoints/best unless it beats the pre-resume best
    best_acc = float(resume_aux.get("best_acc", float("-inf")))
    ema_model = None  # the EMA twin's weights, for its validation

    def save_latest():
        # enqueued async: training continues while it drains; the stop
        # path flushes before exiting
        path = logger.get_checkpoint_path("latest")
        aux = current_stream_aux()
        saver.save(path, ckpt.state_tree(state))
        saver.save_aux(path, best_acc=best_acc, **aux)
        return path

    print("Start regression domain adaptation.")
    # a resume point exists from step 0 on: a stop before the first epoch
    # save no longer loses the pretrain warm start
    save_latest()
    if args.profile:
        from dahpe_tpu_torch.utils import profiling

        for _ in range(2):  # warm-up: cuDNN picks its algorithms
            state, metrics, _, _ = run_iteration(state)
        host_scalars(metrics, ("loss_s",))
        tracedir = os.path.join(args.log, "trace")
        # every rank runs the iterations (they hold collectives); rank 0 traces
        with (profiling.trace(tracedir) if primary else contextlib.nullcontext({})) as summary:
            for _ in range(args.profile):
                state, metrics, _, _ = run_iteration(state)
            host_scalars(metrics, ("loss_s",))
        print(f"profiler trace ({args.profile} iters) -> {tracedir}: {summary}")
    global_step = state.step
    if args.max_steps and global_step >= args.max_steps:
        print(f"--max-steps {args.max_steps} already reached (step {global_step}); "
              "nothing to do")
        saver.close()
        return
    poll_stop = make_stop_poller(stop_signum, args.print_freq)
    for epoch in range(start_epoch, args.epochs):
        logger.set_epoch(epoch)
        batch_time = AverageMeter("Time", ":4.2f")
        meters = {
            "loss_s": AverageMeter("Loss (s)", ":.2e"),
            "loss_gf": AverageMeter("Loss (t, false)", ":.2e"),
            "loss_gt": AverageMeter("Loss (t, truth)", ":.2e"),
            "acc_s": AverageMeter("Acc (s)", ":3.2f"),
            "acc_t": AverageMeter("Acc (t)", ":3.2f"),
        }
        progress = ProgressMeter(args.iters_per_epoch, [batch_time, *meters.values()],
                                 prefix=f"Epoch: [{epoch}]")
        end = time.time()
        first_iter = start_iter if epoch == start_epoch else 0
        for i in range(first_iter, args.iters_per_epoch, chunk):
            state, metrics, b_s, b_t = run_iteration(state)
            global_step += chunk
            if i % args.print_freq == 0:
                vals = host_scalars(metrics, tuple(meters))
                check_finite(saver, logger, state, global_step,
                             **{k: vals[k] for k in DA_LOSSES})
                for k, meter in meters.items():
                    meter.update(vals[k])
                batch_time.update(time.time() - end)
                progress.display(i)
                if visualize is not None:
                    scale = args.image_size / args.heatmap_size
                    for name, batch, pred in (("source", b_s, metrics["pred_s"]),
                                              ("target", b_t, metrics["pred_t"])):
                        visualize(batch["image"][0].cpu().numpy(),
                                  pred[0].cpu().numpy() * scale, f"{name}_{i}_pred")
            end = time.time()
            budget_done = args.max_steps and global_step >= args.max_steps
            stop_sig = poll_stop(global_step)
            if stop_sig or budget_done:
                if stop_sig:
                    print(f"signal {stop_sig}: finished the in-flight iteration, saving "
                          "checkpoints/latest, then exiting cleanly")
                # divergence inside the last print window must not become
                # the advertised resume point
                check_finite(saver, logger, state, global_step,
                             **host_scalars(metrics, DA_LOSSES))
                path = save_latest()
                saver.close()  # the write must land before the exit
                why = "--max-steps reached" if budget_done else "stop requested"
                print(f"{why} at step {global_step} (epoch {epoch} iteration {i}); "
                      f"saved {path} — continue with --resume {path}")
                return
            if args.save_every and global_step % args.save_every == 0:
                check_finite(saver, logger, state, global_step,
                             **host_scalars(metrics, DA_LOSSES))
                save_latest()

        # the epoch checkpoint is finiteness-gated too
        check_finite(saver, logger, state, global_step, **host_scalars(metrics, DA_LOSSES))
        src_acc = validate(val_source_loader, model, val_source, eval_step=eval_step, **val_kw)
        tgt_acc = validate(val_target_loader, model, val_target, eval_step=eval_step,
                           visualize=make_visualizer(val_target, logger) if draw
                           else None, **val_kw)

        # the generator states after the epoch, for both sidecars below (a
        # collective: every rank takes it, whatever rank 0's best decides)
        aux = current_stream_aux()
        epoch_path = logger.get_checkpoint_path(epoch)
        saver.save(epoch_path, ckpt.state_tree(state))
        if state.ema is not None:
            ema_weights = {**model.state_dict(), **state.ema}
            saver.save(logger.get_checkpoint_path("model_ema"), ckpt.model_tree(ema_weights))
            # validate2 counterpart (train1.py:243,270): evaluate the EMA twin
            if ema_model is None:
                ema_model = copy.deepcopy(model)
                ema_eval_step = make_eval_step(ema_model, device=args.device)
            ema_model.load_state_dict(ema_weights)
            ema_acc = validate(val_target_loader, ema_model, val_target,
                               eval_step=ema_eval_step, **val_kw)
            print(f"ema: {ema_acc['all']:4.3f}")
        if tgt_acc["all"] > best_acc:
            best_acc = tgt_acc["all"]
            # the same bytes as the epoch save just enqueued: link host-side
            saver.link(epoch_path, logger.get_checkpoint_path("best"))
            saver.save_aux(logger.get_checkpoint_path("best"), best_acc=best_acc, **aux)
        # aux after the best update: the epoch checkpoint records the current
        # watermark and the post-epoch generator states
        saver.save_aux(epoch_path, best_acc=best_acc, **aux)
        if args.keep_checkpoints > 0:
            # ordered after the pending saves on the worker
            saver.run(lambda d=logger.checkpoint_directory, k=args.keep_checkpoints:
                      ckpt.prune_epoch_checkpoints(d, k))
        print(f"Source: {src_acc['all']:4.3f} Target: {tgt_acc['all']:4.3f} "
              f"Target(best): {best_acc:4.3f}")
        for name, acc in tgt_acc.items():
            print(f"{name}: {acc:4.3f}")
        logger.log_metrics(
            kind="da_epoch", epoch=epoch, step=global_step,
            **{k: m.avg for k, m in meters.items()}, iter_time_s=batch_time.avg,
            val_source=src_acc["all"], val_target=tgt_acc, best_target=best_acc,
            **({"val_target_ema": ema_acc["all"]} if state.ema is not None else {}),
        )

    saver.close()


def cli_main(argv=None) -> int:
    """Run the CLI on ``argv``; the exit code: 0, or 3 after divergence
    (distinct from a crash: a retry wants a lower lr, not the same command)."""
    try:
        main(build_parser("train").parse_args(argv))
    except DivergenceError as e:
        print(f"FATAL: {e}")
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(cli_main())
