"""Validation / inference entry point, on every card of the host.

    python -m mvgformer_tpu_torch.run.validate --cfg <yaml> \
        [--model_path P] [--model_step S] [--save_preds F] \
        [--device cuda] [KEY.SUBKEY=value ...]
    torchrun --standalone --nproc_per_node N \
        -m mvgformer_tpu_torch.run.validate ...

The port of run/validate.py, step for step: the weights from a checkpoint
of the port's train CLI (a directory), from an original-repo `.pth.tar`,
or without either from TRAIN.SEED; the window plan of the windowed layer 1
built once from the first frame's cameras; per confidence threshold the
prediction cache (TEST.PRED_FILE), the eval loop
(`core.infer.predict_dataset`), the escaped-mass telemetry of the windowed
path, DEBUG.LOG_VAL_LOSS, the debug dumps, pose NMS and the dataset's
metrics, the NMS grid (DATASET.NMS_DETAIL / NMS_DETAIL_ALL) and the
per-camera-observability breakdown (DATASET.CAMERA_DETAIL); then the
summary table. `--device` defaults to the card and raises without one.
The model is the one cfg.TRANSFORMER selects.

The debug dumps (DEBUG.VISUALIZATION_JUMP_NUM >= 0, the DQ model only, as
in JAX): every JUMP_NUM-th frame (every frame at 0) gets the debug
forward, once per batch and without the window plan, and
`utils.visualization.visualize_frame` (3D pred vs gt, per-layer 2D
overlays, attention points) into <out>/vis/; under DEBUG.DEBUG also the 3D
grid, the root cubes and the epipolar pickle.

Data parallelism (PARALLEL.DATA, as in the train CLI): each rank predicts
its rows of batches of max(TEST.BATCH_SIZE // ranks, 1) * ranks frames,
the preds are gathered by frame index, and rank 0 alone writes the log,
the prediction files and the debug dumps (of its own rows) and computes
the metrics.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Validate MVGFormer (PyTorch port)")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--model_path", default=None,
                        help="checkpoint dir of the train CLI or an "
                        "original-repo .pth.tar")
    parser.add_argument("--model_step", type=int, default=None,
                        help="checkpoint step (checkpoint dirs only; "
                        "default the latest)")
    parser.add_argument("--save_preds", default=None,
                        help="save raw predictions to this .npy (one file "
                        "per threshold)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser.parse_known_args(argv)


def load_weights(model, path: str, cfg, step: Optional[int] = None):
    """Load a checkpoint into `model`: an original-repo `.pth`/`.tar`
    through utils.torch_convert, else a checkpoint dir of the train CLI.
    Returns the next epoch of a train-CLI checkpoint, else None."""
    if path.endswith((".pth", ".tar")):
        from mvgformer_tpu_torch.utils.torch_convert import \
            load_torch_checkpoint

        model.load_state_dict(load_torch_checkpoint(path, cfg))
        return None
    from mvgformer_tpu_torch.utils.checkpoint import load_params_checkpoint

    restored = load_params_checkpoint(path, step=step)
    if restored is None:
        raise FileNotFoundError(f"{path} (step={step})")
    model.load_state_dict(restored[0])
    return restored[1]


def to_numpy(obj):
    """Tensors (nested in lists, tuples and dicts) as float numpy arrays
    on the host."""
    import torch

    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


def serving_launches() -> dict:
    """The serving kernels' launch counts in this process so far (the
    wrappers count only their launches on the card: 0 on the CPU)."""
    from mvgformer_tpu_torch.ops import deform_attn, window_block, window_dma

    return {fn.__name__: fn.launches for fn in (
        deform_attn.deform_sample, window_block.window_block_matmul,
        window_dma.window_block_dma)}


def debug_dumper(cfg, model, threshold: float, vis_dir: str):
    """The debug dumps of an eval loop, as `predict_dataset`'s on_batch:
    for the batch's frames whose index is a multiple of
    DEBUG.VISUALIZATION_JUMP_NUM, the debug forward (once per batch, no
    window plan) and `visualize_frame`; under DEBUG.DEBUG also
    `save_debug_3d_images`, `save_debug_3d_cubes` and
    `save_debug_epipolar_dump` (a frame that the last batch's padding
    repeats is dumped once)."""
    import torch

    from mvgformer_tpu_torch.utils.visualization import (
        save_debug_3d_cubes, save_debug_3d_images, save_debug_epipolar_dump,
        visualize_frame)

    jump = max(cfg.DEBUG.VISUALIZATION_JUMP_NUM, 1)

    def on_batch(idx, batch, pred):
        dbg = None
        for b, frame_idx in enumerate(idx):
            # the last batch's padding repeats a frame: dump it once
            if frame_idx % jump or frame_idx in idx[:b]:
                continue
            if dbg is None:
                with torch.inference_mode():
                    outs, inter = model(batch, threshold=threshold,
                                        return_intermediates=True)
                dbg = to_numpy(outs), to_numpy(inter), batch.to("cpu")
            outs, inter, host = dbg
            visualize_frame(vis_dir, frame_idx, host, pred[b],
                            layer_outputs=outs, intermediates=inter,
                            batch_index=b)
            if cfg.DEBUG.DEBUG:
                prefix = os.path.join(vis_dir, f"frame{frame_idx}")
                save_debug_3d_images(cfg, host, pred, prefix)
                save_debug_3d_cubes(
                    cfg, host, pred[:, :, cfg.DATASET.ROOTIDX, :4], prefix)
                save_debug_epipolar_dump(host, prefix, batch_index=b)

    return on_batch


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the validation on the ranks PARALLEL.DATA asks for; returns
    rank 0's: per threshold its metrics, the eval loop's frames, seconds,
    Prefetcher wait and escaped mass (None where the preds came from the
    cache), and the world and backend."""
    from mvgformer_tpu_torch.config import load_config
    from mvgformer_tpu_torch.device import resolve_device
    from mvgformer_tpu_torch.parallel import launch

    args, overrides = parse_args(argv)
    cfg = load_config(args.cfg, overrides)
    resolve_device(args.device)
    return launch(validate, cfg.PARALLEL.DATA, args.device, args, cfg)


def validate(dp, args, cfg) -> dict:
    """The validation on this rank (`dp`, a `parallel.DataParallel`)."""
    import numpy as np
    import torch

    from mvgformer_tpu_torch.core.infer import (make_eval_step,
                                                nms_evaluate,
                                                predict_dataset)
    from mvgformer_tpu_torch.data.datasets import get_dataset
    from mvgformer_tpu_torch.models import build_model, is_dq
    from mvgformer_tpu_torch.models.mvgformer import \
        build_layer1_window_plan
    from mvgformer_tpu_torch.utils.logging import create_logger, format_table

    device = dp.device
    logger, out_dir = create_logger(cfg, args.cfg, phase="validate",
                                    write=dp.is_main)
    logger.info("device: %s, rank %d of %d%s", device, dp.rank, dp.world,
                f", backend {dp.backend}" if dp.distributed else "")

    test_ds = get_dataset(cfg, cfg.DATASET.TEST_SUBSET, is_train=False)
    logger.info("eval frames: %d", len(test_ds))
    # cfg.TRANSFORMER: the DQ model or the MvP baseline
    model = build_model(cfg, generator=torch.Generator().manual_seed(
        cfg.TRAIN.SEED), device=device)
    if not args.model_path and cfg.TEST.MODEL_FILE:
        args.model_path = cfg.TEST.MODEL_FILE
        logger.info("using TEST.MODEL_FILE %s", args.model_path)
    if args.model_path:
        next_epoch = load_weights(model, args.model_path, cfg,
                                  args.model_step)
        logger.info("loaded %s (next epoch %s)", args.model_path, next_epoch)
    else:
        logger.info("no checkpoint: weights from TRAIN.SEED %d",
                    cfg.TRAIN.SEED)
    batch_size = max(cfg.TEST.BATCH_SIZE // dp.world, 1) * dp.world

    window_plan = None
    if cfg.DECODER.layer1_windowed_sampling and is_dq(cfg):
        # rig-static (the MvP baseline takes no plan and runs without it,
        # as in JAX): the layer-1 plan from the first frame's cameras, once
        first = test_ds.load_batch([0], load_images=False)
        window_plan = build_layer1_window_plan(
            cfg, first.view_data, tile=cfg.DECODER.layer1_window_tile,
            halo=cfg.DECODER.layer1_window_halo, device=device)

    # the debug overlays read the DQ model's taps; the MvP baseline has
    # none and validates without them, as in JAX
    debug = (cfg.DEBUG.VISUALIZATION_JUMP_NUM >= 0 and is_dq(cfg)
             and dp.is_main)
    results, summary_rows = {}, []
    for thr in cfg.DECODER.inference_conf_thr:
        pred_path = os.path.join(
            out_dir, "{}-{}.npy".format(cfg.TEST.PRED_FILE or "preds", thr))
        loop = None
        if cfg.TEST.PRED_FILE and os.path.isfile(pred_path):
            preds = list(np.load(pred_path))
            logger.info("loaded cached preds from %s", pred_path)
        else:
            telemetry = cfg.DECODER.layer1_windowed_sampling
            eval_step = make_eval_step(cfg, model, threshold=thr,
                                       window_plan=window_plan,
                                       with_escape_telemetry=telemetry,
                                       dp=dp)
            loss_step = None
            if cfg.DEBUG.LOG_VAL_LOSS:
                from mvgformer_tpu_torch.core.train import \
                    make_eval_loss_step

                loss_step = make_eval_loss_step(cfg, model, threshold=thr,
                                                window_plan=window_plan,
                                                dp=dp)
            run = predict_dataset(
                test_ds, eval_step, batch_size, device,
                with_escape_telemetry=telemetry, loss_step=loss_step, dp=dp,
                on_batch=(debug_dumper(cfg, model, thr,
                                       os.path.join(out_dir, "vis"))
                          if debug else None))
            preds = run.preds
            if dp.is_main:
                np.save(pred_path, np.stack(preds))
                logger.info("saved preds to %s", pred_path)
            logger.info("eval loop: %d frames in %.3f s (%.3f frames/s), "
                        "prefetch wait %.3f s", len(preds), run.loop_s,
                        len(preds) / run.loop_s, run.wait_s)
            logger.info("kernel launches: %s", serving_launches())
            loop = {"frames": len(preds), "loop_s": run.loop_s,
                    "wait_s": run.wait_s,
                    "escaped_mass": run.escaped_mass if telemetry else None}
            if telemetry:
                logger.info(
                    "windowed-sampling escaped weight mass: %.6g over %d "
                    "frames (%.3g/frame; >0 means ON-MAP samples left "
                    "their halo and read zero: raise layer1_window_halo "
                    "or set layer1_offset_clamp)", run.escaped_mass,
                    len(preds), run.escaped_mass / max(len(preds), 1))
            if loss_step is not None and run.loss_batches:
                logger.info("val loss thr=%s  %s", thr, {
                    k: round(v / run.loss_batches, 5)
                    for k, v in sorted(run.loss_sums.items())})
        if not dp.is_main:  # rank 0 writes and scores the preds
            continue
        if args.save_preds:
            root, ext = os.path.splitext(args.save_preds)
            np.save(f"{root}-{thr}{ext or '.npy'}", np.stack(preds))

        metrics = nms_evaluate(test_ds, preds)
        results[thr] = {"metrics": metrics, "loop": loop,
                        "world": dp.world, "backend": dp.backend}
        if isinstance(metrics, dict):
            logger.info("thr=%s  %s", thr,
                        {k: round(v, 4) for k, v in metrics.items()})
            summary_rows.append(
                [thr] + [float(metrics.get(k, 0.0))
                         for k in ("ap@25", "ap@50", "ap@100", "ap@150",
                                   "recall@25", "mpjpe", "recall@500")])
            if cfg.DATASET.NMS_DETAIL:
                # the NMS operating-point grid (the full one under
                # NMS_DETAIL_ALL)
                if cfg.DATASET.NMS_DETAIL_ALL:
                    dist_thrs = [0.01, 0.03, 0.05, 0.06, 0.07, 0.08, 0.09,
                                 0.1, 0.2, 0.3, 0.4, 0.5, 0.8]
                    nearby_thrs = [3, 4, 5, 6, 7, 8, 9, 10, 13]
                else:
                    dist_thrs, nearby_thrs = [0.3], [7]
                for d in dist_thrs:
                    for nb in nearby_thrs:
                        m = (metrics if (d, nb) == (0.3, 7)
                             else nms_evaluate(test_ds, preds, d, nb))
                        logger.info(
                            "nms dist=%.2f nearby=%d  ap25=%.4f "
                            "ap100=%.4f mpjpe=%.2f recall@500=%.4f",
                            d, nb, m.get("ap@25", 0.0), m.get("ap@100", 0.0),
                            m.get("mpjpe", 0.0), m.get("recall@500", 0.0))
            if cfg.DATASET.CAMERA_DETAIL:
                arrays = test_ds.observability_arrays(len(preds))
                if arrays is not None:
                    from mvgformer_tpu_torch.core.evaluate import \
                        evaluate_by_observability
                    from mvgformer_tpu_torch.core.nms import apply_pose_nms

                    gts, vis3d, vis = arrays
                    obs = evaluate_by_observability(
                        [apply_pose_nms(p) for p in preds], gts, vis,
                        num_views=test_ds.num_views, gt_vis3d=vis3d)
                    for (pct, ncam), m in sorted(obs.items()):
                        logger.info(
                            "obs>=%d%% cams=%d  n_gt=%d ap25=%.4f "
                            "mpjpe=%.2f", pct, ncam, m["num_gt"],
                            m.get("ap@25", 0.0), m.get("mpjpe", 0.0))
                else:
                    logger.info("CAMERA_DETAIL: dataset has no per-view "
                                "2D visibility; skipped")
        else:
            actor_pcp, avg_pcp, bone_pcp, recall = metrics
            logger.info("thr=%s  PCP per-actor %s avg %.4f recall@500 %.4f",
                        thr, np.round(actor_pcp, 4), avg_pcp, recall)
            for k, v in bone_pcp.items():
                logger.info("  %s: %s", k, np.round(v, 4))
            summary_rows.append([thr, float(avg_pcp), float(recall)])

    if summary_rows:
        if len(summary_rows[0]) == 8:
            headers = ["thr", "ap@25", "ap@50", "ap@100", "ap@150",
                       "recall@25", "mpjpe", "recall@500"]
        else:
            headers = ["thr", "pcp_avg", "recall@500"]
        logger.info("summary:\n%s", format_table(headers, summary_rows))
    return results


if __name__ == "__main__":
    main()
