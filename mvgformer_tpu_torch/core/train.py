"""The training step: match -> forward -> criterion -> backward -> clip ->
Adam.

Port of `mvgformer_tpu/core/train.py`. The optimizer is written out as
optax composes it there, so the two frameworks update alike:

    apply_if_finite(                      # TRAIN.SKIP_NONFINITE only
      chain(clip_by_global_norm(TRAIN.clip_max_norm),
            multi_transform({main: adam(lr), proj: adam(lr * mult),
                             frozen: set_to_zero()})))

  * one global norm over every gradient, the frozen ones included (they
    are absent here, zeros in JAX); the gradients are scaled by
    max_norm / norm only when norm >= max_norm, with no epsilon;
  * Adam with b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias
    corrected; the step size follows `make_lr_schedule` per group: 'proj'
    (names holding 'sampling_offsets' or 'reference_points') at
    DECODER.lr_linear_proj_mult times 'main'; 'frozen' (the backbone unless
    TRAIN.TRAIN_BACKBONE) is never updated;
  * with SKIP_NONFINITE a step whose gradients are not all finite updates
    nothing and does not advance Adam, unless it is the 101st such step in
    a row (optax's max_consecutive_errors=100); `notfinite_total` counts
    them.

The model's parameters are the state's parameters: a step updates them in
place. Every decision of the update (the clip, the SKIP_NONFINITE test,
the step count behind the schedule and the bias corrections) is made on
the parameters' device, as optax makes it inside the jitted step, so a
step reads nothing back to the host: the counters of `OptState` are 0-d
int32 tensors there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch

from mvgformer_tpu_torch.config import Config
from mvgformer_tpu_torch.core.criterion import compute_losses, match_queries
from mvgformer_tpu_torch.data.meta import Batch
from mvgformer_tpu_torch.models import is_dq, refuse_volumetric
from mvgformer_tpu_torch.ops.window_sampling import WindowPlan
from mvgformer_tpu_torch.parallel.mesh import DataParallel, all_reduce_grads
from mvgformer_tpu_torch.utils.profiling import span

MAX_CONSECUTIVE_ERRORS = 100


@dataclasses.dataclass
class OptState:
    count: torch.Tensor           # Adam and schedule steps taken
    mu: Dict[str, torch.Tensor]   # first moments of the updated params
    nu: Dict[str, torch.Tensor]   # second moments
    notfinite_count: torch.Tensor = 0  # non-finite steps in a row
    total_notfinite: torch.Tensor = 0  # non-finite steps in all


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    opt_state: OptState


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], torch.Tensor]:
    """step -> learning rate: multistep (LR_FACTOR at each LR_STEP epoch) or
    cosine over END_EPOCH, joined at `warmup` steps to a linear warmup from
    0 (TRAIN.WARMUP_EPOCHS); the multistep boundaries sit at
    epoch * steps_per_epoch - warmup steps of the main schedule. The step
    is an int or a 0-d tensor (the optimizer's count, on its device); the
    rate is a float64 0-d tensor on the step's device."""
    base = cfg.TRAIN.LR
    total = cfg.TRAIN.END_EPOCH * steps_per_epoch
    warmup = int(cfg.TRAIN.WARMUP_EPOCHS * steps_per_epoch)
    if cfg.TRAIN.LR_SCHEDULER == "cosine":
        decay_steps = max(total - warmup, 1)

        def main(step):
            count = torch.clamp(step, max=decay_steps)
            return base * 0.5 * (1.0 + torch.cos(math.pi * count
                                                 / decay_steps))
    else:
        boundaries = sorted({max(int(e) * steps_per_epoch - warmup, 1):
                             cfg.TRAIN.LR_FACTOR
                             for e in cfg.TRAIN.LR_STEP}.items())

        def main(step):
            lr = torch.full_like(step, base)
            for boundary, scale in boundaries:
                lr = torch.where(step >= boundary, lr * scale, lr)
            return lr

    def schedule(step):
        step = torch.as_tensor(step, dtype=torch.float64)
        if not warmup:
            return main(step)
        return torch.where(step < warmup, base * step / warmup,
                           main(step - warmup))

    return schedule


def _param_labels(names: Iterable[str],
                  train_backbone: bool = False) -> Dict[str, str]:
    """name -> 'frozen' (the backbone), 'proj' (the lr_linear_proj_mult
    group: 'sampling_offsets' or 'reference_points' in the name) or
    'main'."""
    labels = {}
    for name in names:
        if name.startswith("backbone.") and not train_backbone:
            labels[name] = "frozen"
        elif "sampling_offsets" in name or "reference_points" in name:
            labels[name] = "proj"
        else:
            labels[name] = "main"
    return labels


class Optimizer:
    """The clipped two-group Adam of `make_optimizer`, on dicts of tensors
    keyed by parameter name: `init(params)` and `update(grads, state,
    params) -> (updates, state)`, as an optax transformation."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, cfg: Config, steps_per_epoch: int):
        self.schedule = make_lr_schedule(cfg, steps_per_epoch)
        self.scale = {"main": 1.0, "proj": cfg.DECODER.lr_linear_proj_mult}
        self.max_norm = cfg.TRAIN.clip_max_norm
        self.train_backbone = cfg.TRAIN.TRAIN_BACKBONE
        self.skip_nonfinite = cfg.TRAIN.SKIP_NONFINITE

    def labels(self, names: Iterable[str]) -> Dict[str, str]:
        return _param_labels(names, self.train_backbone)

    def init(self, params: Mapping[str, torch.Tensor]) -> OptState:
        labels = self.labels(params)
        moments = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items() if labels[k] != "frozen"}
        device = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        return OptState(count=zero, mu=moments,
                        nu={k: torch.zeros_like(m)
                            for k, m in moments.items()},
                        notfinite_count=zero, total_notfinite=zero)

    def update(self, grads: Mapping[str, Optional[torch.Tensor]],
               state: OptState, params: Mapping[str, torch.Tensor]
               ) -> Tuple[Dict[str, Optional[torch.Tensor]], OptState]:
        """Updates to add to the params (None: leave it as it is). A
        gradient of None counts as zeros. Under SKIP_NONFINITE a rejected
        step's gradients are zeroed and its moment blend and step size are
        (1, 0): the moments and count stay the old ones, the updates are
        zeros. The gradients are copied into one flat buffer (one test,
        one select, one norm, one clip) and Adam runs as multi-tensor ops,
        so the launches do not grow with the number of leaves."""
        device = next(iter(params.values())).device
        count, notfinite_count, total_notfinite = (
            torch.as_tensor(c, dtype=torch.int32, device=device)
            for c in (state.count, state.notfinite_count,
                      state.total_notfinite))
        present = {k: g for k, g in grads.items() if g is not None}
        flat = (torch.cat([g.reshape(-1) for g in present.values()]).float()
                if present else torch.zeros(0, device=device))
        apply = None
        if self.skip_nonfinite:
            finite = torch.isfinite(flat).all()
            notfinite_count = torch.where(finite, 0, notfinite_count + 1)
            total_notfinite = total_notfinite + (~finite).int()
            apply = finite | (notfinite_count > MAX_CONSECUTIVE_ERRORS)
            flat = torch.where(apply, flat, 0.0)

        def pick(applied, rejected):
            return applied if apply is None else torch.where(
                apply, applied, rejected)

        if self.max_norm > 0:
            # not linalg.vector_norm: its float32 sum on the CPU drifts
            norm = torch.sqrt((flat * flat).sum())
            keep = norm < self.max_norm
            # (g / norm) * max_norm where clipped, g / 1 * 1 where not
            flat = (flat / torch.where(keep, 1.0, norm)
                    * torch.where(keep, 1.0, self.max_norm))
        views = dict(zip(present, torch.split(
            flat, [g.numel() for g in present.values()])))

        keys = list(state.mu)
        G = [views[k].view_as(state.mu[k]) if k in views
             else torch.zeros_like(state.mu[k]) for k in keys]
        new_count = count + 1
        bc1 = 1 - torch.full((), self.b1, device=device) ** new_count
        bc2 = 1 - torch.full((), self.b2, device=device) ** new_count
        # (1 - b1) * g + b1 * m and (1 - b2) * g * g + b2 * v
        mu = torch._foreach_mul([state.mu[k] for k in keys],
                                pick(self.b1, 1.0))
        torch._foreach_add_(mu, torch._foreach_mul(G, pick(1 - self.b1,
                                                           0.0)))
        nu = torch._foreach_mul([state.nu[k] for k in keys],
                                pick(self.b2, 1.0))
        gg = torch._foreach_mul(G, G)
        torch._foreach_mul_(gg, pick(1 - self.b2, 0.0))
        torch._foreach_add_(nu, gg)
        # (mu / bc1) / (sqrt(nu / bc2) + eps), times -lr per group
        step = torch._foreach_div(mu, bc1)
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(step, den)
        lr = self.schedule(count)
        labels = self.labels(params)
        for group, scale in self.scale.items():
            idx = [i for i, k in enumerate(keys) if labels[k] == group]
            if idx:
                torch._foreach_mul_([step[i] for i in idx],
                                    pick((-lr * scale).float(), 0.0))
        updates = {k: None for k in params}
        updates.update(zip(keys, step))
        return updates, OptState(count=pick(new_count, count),
                                 mu=dict(zip(keys, mu)),
                                 nu=dict(zip(keys, nu)),
                                 notfinite_count=notfinite_count,
                                 total_notfinite=total_notfinite)


def make_optimizer(cfg: Config, steps_per_epoch: int) -> Optimizer:
    return Optimizer(cfg, steps_per_epoch)


def create_train_state(cfg: Config, model: torch.nn.Module,
                       steps_per_epoch: int = 1000
                       ) -> Tuple[TrainState, Optimizer]:
    """The state of an initialized model (its weights made from a seed or
    loaded) at step 0, and its optimizer."""
    tx = make_optimizer(cfg, steps_per_epoch)
    opt_state = tx.init(dict(model.named_parameters()))
    return TrainState(step=0, model=model, opt_state=opt_state), tx


def make_train_step(cfg: Config, model: torch.nn.Module, tx: Optimizer,
                    num_replicas: int = 1,
                    dp: Optional[DataParallel] = None) -> Callable:
    """train_step(state, batch, generator=None) -> (state, metrics).

    The gt match on the initial query grid, the training forward of every
    decoder layer (dropout from `generator`), the criterion, the backward,
    the clipped Adam update of the model's parameters in place. metrics
    holds every loss term as a scalar tensor, and `notfinite_total` under
    TRAIN.SKIP_NONFINITE. The MvP baseline has no query grid: the
    criterion matches each of its layers on the layer's own outputs.

    dp: under data parallelism (a `parallel.DataParallel` of more than one
    rank) the batch is this rank's rows; the criterion normalizes by the
    ranks' mean sample count, and between the backward and the update the
    gradients of every trainable parameter and the loss terms are averaged
    over the ranks in one all-reduce, so every rank clips the same global
    gradient, takes the same Adam step (and the same SKIP_NONFINITE
    decision) and returns the global batch's losses. Under a view split
    (`dp.views` > 1) the batch holds this rank's views too: the forward
    and the criterion reduce over the view group (`parallel/
    collectives.py`), every rank of a data row computes the row's full
    loss, and the same one all-reduce over the whole grid gives the
    gradient of one process per data row (the derivation is in that
    module). Dropout must draw the same masks on the ranks of a data row:
    seed `generator` by data row (TRAIN.SEED + dp.data_rank), not by
    rank."""
    refuse_volumetric(cfg, "make_train_step")
    dq = is_dq(cfg)
    distributed = dp is not None and dp.distributed
    gt_match = cfg.DECODER.gt_match and dq

    def train_step(state: TrainState, batch: Batch,
                   generator: Optional[torch.Generator] = None):
        with span("mvg.step"):
            return _step(state, batch, generator)

    def _step(state, batch, generator):
        mdl = state.model
        mdl.train()
        params = dict(mdl.named_parameters())
        for p in params.values():
            p.grad = None
        if dq:
            with span("mvg.match"):
                init_refs = mdl.initial_reference_points_static(
                    batch.views.shape[0])
                # with gt_match off the criterion matches per layer and
                # this match is unused, as in JAX
                match = match_queries(cfg, init_refs, batch)
            with span("mvg.forward"):
                outs = mdl(batch,
                           query_mask=match.query_mask if gt_match else None,
                           train=True, generator=generator, grid=dp)
        else:
            init_refs = match = None
            with span("mvg.forward"):
                outs = mdl(batch, train=True, generator=generator, grid=dp)
        with span("mvg.loss"):
            losses = compute_losses(cfg, outs, batch,
                                    match if gt_match else None,
                                    init_reference=init_refs,
                                    num_replicas=num_replicas, dp=dp)
        with span("mvg.backward"):
            losses["total"].backward()
        with span("mvg.update"):
            if distributed:
                labels = tx.labels(params)
                keys = list(losses)
                mean = all_reduce_grads(
                    [p for k, p in params.items() if labels[k] != "frozen"],
                    dp, torch.stack([losses[k].detach().float()
                                     for k in keys]))
                losses = dict(zip(keys, mean))
            updates, opt_state = tx.update(
                {k: p.grad for k, p in params.items()}, state.opt_state,
                params)
            applied = [k for k, u in updates.items() if u is not None]
            with torch.no_grad():
                torch._foreach_add_([params[k] for k in applied],
                                    [updates[k] for k in applied])
        metrics = {k: v.detach() for k, v in losses.items()}
        if cfg.TRAIN.SKIP_NONFINITE:
            metrics["notfinite_total"] = opt_state.total_notfinite
        return TrainState(step=state.step + 1, model=mdl,
                          opt_state=opt_state), metrics

    return train_step


def make_eval_loss_step(cfg: Config, model: torch.nn.Module, threshold: float,
                        window_plan: Optional[WindowPlan] = None,
                        dp: Optional[DataParallel] = None) -> Callable:
    """The loss dict on eval batches (DEBUG.LOG_VAL_LOSS): the serving
    forward (threshold filtering, no gt match) with the criterion matching
    each layer's own outputs. The MvP baseline takes no window plan: passing
    one raises. dp: the grid under data or view parallelism (the batch is
    this rank's shard), as `make_train_step` takes it."""
    refuse_volumetric(cfg, "make_eval_loss_step")
    dq = is_dq(cfg)
    if window_plan is not None and not dq:
        raise ValueError("the window plan is for the DQ model's layer 1; "
                         "the MvP baseline takes none")

    @torch.no_grad()
    def loss_step(batch: Batch) -> Dict[str, torch.Tensor]:
        model.eval()
        if dq:
            outs = model(batch, threshold=threshold,
                         window_plan=window_plan, grid=dp)
        else:
            outs = model(batch, grid=dp)
        return compute_losses(cfg, outs, batch, None, dp=dp)

    return loss_step
