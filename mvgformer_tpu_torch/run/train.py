"""Training entry point, on every card of the host.

    python -m mvgformer_tpu_torch.run.train --cfg <yaml> [--max_steps N] \
        [--device cuda] [KEY.SUBKEY=value ...]
    torchrun --standalone --nproc_per_node N \
        -m mvgformer_tpu_torch.run.train ...

The port of run/train.py, step for step: the train and test datasets; the
model's weights from TRAIN.SEED, then NETWORK.PRETRAINED_BACKBONE and
TRAIN.FINETUNE_MODEL; TRAIN.RESUME from the latest checkpoint; per epoch
the training loop over a Prefetcher (dropout from a generator on the
device seeded with TRAIN.SEED + data rank, the per-step metrics logged through
a MetricLogger every PRINT_FREQ steps, preemption checkpoints), the
device's memory, the eval at each confidence threshold (`core.infer.
evaluate_dataset`; DEBUG.LOG_VAL_LOSS on the first), best-precision
tracking and the checkpoint. `--device` defaults to the card and raises
without one.

Data parallelism (PARALLEL.DATA: -1 every visible card, N at most N; on
the CPU N processes, -1 one): launched plainly, the CLI starts one process
per rank itself (`parallel.launch`); under torchrun it joins torchrun's
group. Every rank walks the same global batches of TRAIN.BATCH_SIZE *
ranks frames and takes its rows; the step averages the gradients over the
ranks (`core.train.make_train_step(..., dp=)`). Rank 0 alone writes the
log, the tracker, the checkpoints; a preemption request on any rank stops
every rank at the same step.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Train MVGFormer (PyTorch port)")
    parser.add_argument("--cfg", required=True, help="experiment yaml")
    parser.add_argument("--max_steps", type=int, default=None,
                        help="optional step cap (smoke runs)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_known_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the training on the ranks PARALLEL.DATA asks for; returns rank
    0's summary: its steps, each step's losses (the mean over the ranks)
    and host seconds (the losses read back, so the step has ended), the
    training loop's seconds and Prefetcher wait, each epoch's eval
    metrics, the best precision, the checkpoint directory, the world and
    the backend."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.device import resolve_device
    from mvgformer_tpu_torch.parallel import launch

    args, overrides = parse_args(argv)
    cfg = load_config(args.cfg, overrides)
    resolve_device(args.device)
    return launch(train, cfg.PARALLEL.DATA, args.device, args, cfg)


def train(dp, args, cfg) -> dict:
    """The training on this rank (`dp`, a `parallel.DataParallel`)."""
    import numpy as np
    import torch

    from mvgformer_tpu_torch.core.infer import (evaluate_dataset,
                                                make_eval_step)
    from mvgformer_tpu_torch.core.train import (create_train_state,
                                                make_eval_loss_step,
                                                make_train_step)
    from mvgformer_tpu_torch.data.datasets import get_dataset
    from mvgformer_tpu_torch.data.prefetch import DevicePlacer
    from mvgformer_tpu_torch.models import build_model, is_dq
    from mvgformer_tpu_torch.models.mvgformer import \
        build_layer1_window_plan
    from mvgformer_tpu_torch.parallel import replicated
    from mvgformer_tpu_torch.parallel.mesh import any_rank, broadcast_object
    from mvgformer_tpu_torch.run.validate import load_weights
    from mvgformer_tpu_torch.utils.checkpoint import (
        PreemptionGuard, load_backbone_pretrained, load_checkpoint,
        save_checkpoint)
    from mvgformer_tpu_torch.utils.logging import (ExperimentTracker,
                                                   MetricLogger,
                                                   create_logger)

    device = dp.device
    logger, out_dir = create_logger(cfg, args.cfg, phase="train",
                                    write=dp.is_main)
    logger.info("device: %s%s, rank %d of %d%s", device, (
        f" ({torch.cuda.get_device_name(device)})"
        if device.type == "cuda" else ""), dp.rank, dp.world,
        f", backend {dp.backend}" if dp.distributed else "")
    tracker = (ExperimentTracker(out_dir, run_name=os.path.basename(args.cfg),
                                 config=dataclasses.asdict(cfg))
               if dp.is_main else None)

    train_ds = get_dataset(cfg, cfg.DATASET.TRAIN_SUBSET, is_train=True)
    test_ds = get_dataset(cfg, cfg.DATASET.TEST_SUBSET, is_train=False)
    logger.info("train frames: %d, test frames: %d",
                len(train_ds), len(test_ds))
    # every rank walks the same global batches and takes its rows
    global_batch = cfg.TRAIN.BATCH_SIZE * dp.world
    rows = dp.rows(global_batch) if dp.distributed else None
    steps_per_epoch = max(len(train_ds) // global_batch, 1)

    # cfg.TRANSFORMER: the DQ model or the MvP baseline
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        cfg.TRAIN.SEED), device=device)
    if cfg.NETWORK.PRETRAINED_BACKBONE:
        model.load_state_dict(load_backbone_pretrained(
            cfg.NETWORK.PRETRAINED_BACKBONE, model.state_dict()))
        logger.info("loaded pretrained backbone %s",
                    cfg.NETWORK.PRETRAINED_BACKBONE)
    if cfg.TRAIN.FINETUNE_MODEL:
        # weights only; the epoch and the optimizer start fresh
        load_weights(model, cfg.TRAIN.FINETUNE_MODEL, cfg)
        logger.info("finetuning from %s", cfg.TRAIN.FINETUNE_MODEL)
    replicated(model, dp)
    state, tx = create_train_state(cfg, model,
                                   steps_per_epoch=steps_per_epoch)

    ckpt_dir = os.path.join(out_dir, "checkpoints")
    begin_epoch = cfg.TRAIN.BEGIN_EPOCH
    best_precision = 0.0
    if cfg.TRAIN.RESUME:
        restored = load_checkpoint(ckpt_dir, state)
        if restored is not None:
            state, begin_epoch, best_precision = restored
            logger.info("resumed from epoch %d", begin_epoch)

    train_step = make_train_step(cfg, model, tx, dp=dp)
    eval_batch = max(cfg.TEST.BATCH_SIZE // dp.world, 1) * dp.world
    window_plan = None
    # the MvP baseline takes no plan and runs without it, as in JAX
    if cfg.DECODER.layer1_windowed_sampling and is_dq(cfg):
        window_plan = build_layer1_window_plan(
            cfg, test_ds.load_batch([0], load_images=False).view_data,
            tile=cfg.DECODER.layer1_window_tile,
            halo=cfg.DECODER.layer1_window_halo, device=device)
    eval_steps = {thr: make_eval_step(cfg, model, threshold=thr,
                                      window_plan=window_plan, dp=dp)
                  for thr in cfg.DECODER.inference_conf_thr}
    eval_loss_step = None
    if cfg.DEBUG.LOG_VAL_LOSS:
        eval_loss_step = make_eval_loss_step(
            cfg, model, threshold=cfg.DECODER.inference_conf_thr[0],
            window_plan=window_plan, dp=dp)

    placer = DevicePlacer(device)
    # each data row draws its own dropout masks (the ranks of a row, under
    # a view split, the same ones)
    generator = torch.Generator().manual_seed(cfg.TRAIN.SEED + dp.data_rank)
    guard = PreemptionGuard()
    total_steps = 0
    result = {"steps": 0, "step_losses": [], "step_s": [],
              "train_loop_s": 0.0,
              "train_wait_s": 0.0, "evals": [], "ckpt_dir": ckpt_dir,
              "world": dp.world, "backend": dp.backend}
    for epoch in range(begin_epoch, cfg.TRAIN.END_EPOCH):
        meter = MetricLogger()
        t_epoch = time.time()
        loader = placer.prefetch(train_ds.batches(
            global_batch, shuffle=cfg.TRAIN.SHUFFLE,
            seed=cfg.TRAIN.SEED + epoch, rows=rows))
        t_loop = time.perf_counter()
        stop = False
        for step, (idx, batch) in enumerate(loader):
            t_step = time.perf_counter()
            state, metrics = train_step(state, batch, generator)
            losses = {k: float(v) for k, v in metrics.items()}
            result["step_s"].append(time.perf_counter() - t_step)
            meter.update(losses)
            meter.update({"data_wait_s": loader.last_wait_s})
            result["step_losses"].append(losses)
            total_steps += 1
            if step % cfg.PRINT_FREQ == 0:
                logger.info("epoch %d step %d | %s", epoch, step,
                            meter.format())
                if tracker:
                    tracker.log({k: m.avg for k, m in meter.meters.items()},
                                step=total_steps, epoch=epoch,
                                prefix="train/")
            if args.max_steps and total_steps >= args.max_steps:
                break
            if any_rank(guard.should_stop, dp):
                logger.info("preemption requested; checkpointing epoch %d",
                            epoch)
                # a mid-epoch save: the resumed run re-runs this epoch
                if dp.is_main:
                    save_checkpoint(ckpt_dir, state, epoch, best_precision,
                                    next_epoch=epoch)
                stop = True
                break
        loader.close()
        result["train_loop_s"] += time.perf_counter() - t_loop
        result["train_wait_s"] += loader.total_wait_s
        result["steps"] = total_steps
        if stop:
            return result

        logger.info("epoch %d done in %.1fs | %s", epoch,
                    time.time() - t_epoch, meter.format())
        if device.type == "cuda":
            logger.info("device memory: %.2f GiB allocated, %.2f GiB peak",
                        torch.cuda.memory_allocated(device) / 2 ** 30,
                        torch.cuda.max_memory_allocated(device) / 2 ** 30)
        if any_rank(guard.should_stop, dp):
            logger.info("preemption requested post-epoch; checkpointing")
            if dp.is_main:
                save_checkpoint(ckpt_dir, state, epoch, best_precision,
                                next_epoch=epoch + 1)
            return result

        # the eval at each confidence threshold; the best precision is
        # the best over thresholds and epochs
        precision = 0.0
        val_losses = None
        for thr, eval_step in eval_steps.items():
            first = thr == next(iter(eval_steps))
            metrics, run = evaluate_dataset(
                test_ds, eval_step, eval_batch, device, dp=dp,
                loss_step=eval_loss_step if first else None)
            if first and eval_loss_step is not None:
                val_losses = {k: v / max(run.loss_batches, 1)
                              for k, v in run.loss_sums.items()}
            result["evals"].append({"epoch": epoch, "thr": thr,
                                    "metrics": metrics,
                                    "frames": len(run.preds),
                                    "loop_s": run.loop_s,
                                    "wait_s": run.wait_s})
            if metrics is None:  # computed on rank 0
                continue
            if isinstance(metrics, dict):
                logger.info("eval epoch %d thr %s: %s", epoch, thr, {
                    k: round(v, 4) for k, v in metrics.items()})
                precision = max(precision, metrics.get("ap@25", 0.0))
                tracker.log(metrics, epoch=epoch, prefix="eval/")
            else:  # PCP datasets
                actor_pcp, avg_pcp, _, recall = metrics
                logger.info(
                    "eval epoch %d thr %s: PCP %s avg %.4f recall %.4f",
                    epoch, thr, np.round(actor_pcp, 4), avg_pcp, recall)
                precision = max(precision, avg_pcp)
                tracker.log({"pcp_avg": avg_pcp}, epoch=epoch,
                            prefix="eval/")
        if val_losses and tracker:
            logger.info("val loss epoch %d | %s", epoch, " ".join(
                f"{k}={v:.4f}" for k, v in sorted(val_losses.items())))
            tracker.log(val_losses, epoch=epoch, prefix="val_loss/")

        precision = broadcast_object(precision, dp)
        is_best = precision > best_precision
        best_precision = max(best_precision, precision)
        # the best precision so far, and epoch + 1 as the resume point
        if dp.is_main:
            save_checkpoint(ckpt_dir, state, epoch, best_precision, is_best,
                            next_epoch=epoch + 1)
        if args.max_steps and total_steps >= args.max_steps:
            break

    logger.info("done; best precision %.4f", best_precision)
    result["best_precision"] = best_precision
    return result


if __name__ == "__main__":
    main()
