"""Data and view parallelism over the cards of one host (or over CPU
processes).

The port's counterpart of `mvgformer_tpu/parallel/mesh.py`. JAX runs one
program over a mesh and lets XLA insert the collectives; here each rank is
a process that holds a full replica of the model and the collectives are
written out.

The grid is JAX's (data x view) mesh (`make_mesh_2d(data, view)`): rank
r = data_rank * views + view_rank, in JAX's mesh order. The ranks of one
data row (a view group) take the same frames and split their views; the
ranks of one view slot (a data group) take other frames. A view world of
1 is the 1-D data mesh (`make_mesh(data)`) and runs the single-device
model path unchanged.

  * `data_world(num, device)`: PARALLEL.DATA capped at the visible cards,
    -1 (or 0) meaning all of them; on the CPU -1 means 1 process.
  * `init_data_parallel(num, device, views=1)`: this process's
    `DataParallel` (rank, world, device, the world's process group, and
    under a view split the group of its data row and of its view slot).
    Under torchrun (RANK, WORLD_SIZE and LOCAL_RANK set) it joins
    torchrun's group; a launcher of its own passes rank, world and an
    init_method (`launch`).
  * The backend rule: NCCL where every rank has a card of its own, gloo
    on the CPU and where two ranks share a card (NCCL refuses that).
  * `shard_batch(batch, dp)`: this rank's rows [data_rank*B,
    (data_rank+1)*B) of a global batch and, under a view split, its
    contiguous slice of the view axis of `views` and `view_data`; the
    `targets` keep every view. These are the shards JAX's
    `shard_batch(..., view_axis="view")` places on device `rank`.
  * `replicated(model, dp)`: rank 0's parameters and buffers on every rank.
  * `all_reduce_grads(params, dp, extras)`: the mean over every rank of
    the grid of the gradients and of the loss terms, in one flat float32
    buffer, once per step (`parallel/collectives.py` shows why the mean
    over the whole grid is exact under a view split).
  * `launch(fn, num, device, *args, views=1)`: run fn(dp, *args) on the
    grid of `num` data rows x `views` view ranks, in spawned processes
    (`spawn`) or under torchrun, and return rank 0's result.

The collectives inside the model's forward (the mean over views, the
triangulation's gather, ...) are in `parallel/collectives.py`.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import tempfile
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

logger = logging.getLogger("mvgformer_tpu_torch")

TORCHRUN_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """This process's place in the (data x view) grid. A world of 1 has
    no process group and runs the single-device path unchanged; a view
    world (`views`) of 1 is plain data parallelism."""

    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    group: Any = None            # the world's group; None for a world of 1
    backend: Optional[str] = None
    views: int = 1               # the ranks of a data row (the view world)
    view_group: Any = None       # this data row's ranks; None for 1 view
    data_group: Any = None       # this view slot's ranks; None for 1 row

    def __post_init__(self):
        if self.views < 1 or self.world % self.views:
            raise ValueError(f"a world of {self.world} ranks does not form "
                             f"a grid with {self.views} views per row")

    @property
    def distributed(self) -> bool:
        return self.world > 1

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_world(self) -> int:
        return self.world // self.views

    @property
    def data_rank(self) -> int:
        return self.rank // self.views

    @property
    def view_rank(self) -> int:
        return self.rank % self.views

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch of `global_batch` frames."""
        if global_batch % self.data_world:
            raise ValueError(f"a global batch of {global_batch} does not "
                             f"split over {self.data_world} ranks")
        per = global_batch // self.data_world
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def view_slice(self, num_views: int) -> slice:
        """This rank's contiguous views of a frame's `num_views`."""
        if num_views % self.views:
            raise ValueError(f"{num_views} views do not split over "
                             f"{self.views} view ranks")
        per = num_views // self.views
        return slice(self.view_rank * per, (self.view_rank + 1) * per)


def under_torchrun() -> bool:
    return all(v in os.environ for v in TORCHRUN_VARS)


def visible_cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def data_world(num: int, device="cuda") -> int:
    """The data-parallel world PARALLEL.DATA asks for: -1 (or 0) means
    every visible card, N is capped at the visible cards. On the CPU, N
    processes, and -1 means 1."""
    if torch.device(device).type == "cpu":
        return num if num > 0 else 1
    cards = visible_cards()
    if cards == 0:
        raise RuntimeError("PARALLEL.DATA on the card, but no CUDA card is "
                           "available: pass device='cpu' to run on the CPU")
    return cards if num <= 0 else min(num, cards)


def choose_backend(device_type: str, world: int, cards: int) -> str:
    """NCCL when every rank has a card of its own; gloo on the CPU, and
    when ranks share a card, which NCCL refuses."""
    if device_type == "cuda" and world <= cards:
        return "nccl"
    return "gloo"


def init_data_parallel(num: int = -1, device="cuda",
                       rank: Optional[int] = None,
                       world: Optional[int] = None,
                       init_method: Optional[str] = None,
                       views: int = 1) -> DataParallel:
    """Join (or make) the process group of this process, and under a view
    split (`views` > 1) the groups of its data row and its view slot.

    Under torchrun the world is torchrun's, and a PARALLEL.DATA (`num`)
    other than -1 or the world's data rows raises. Otherwise `rank`,
    `world` and `init_method` come from the launcher (`launch`); without
    them the world must be 1. The device is cuda:(local rank % visible
    cards), or the CPU. A world of 1 makes no process group."""
    device_type = torch.device(device).type
    local_rank = rank
    if under_torchrun():
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ["LOCAL_RANK"])
        if num > 0 and num * views != world:
            raise ValueError(f"PARALLEL.DATA={num} under torchrun with a "
                             f"world of {world}: set -1 or "
                             f"{world // views}")
        init_method = "env://"
    elif rank is None:
        world = data_world(num, device)
        if world > 1:
            raise RuntimeError(
                f"a data-parallel world of {world} needs its processes: "
                f"launch with torchrun or through parallel.launch")
        rank = local_rank = 0
    if device_type == "cuda":
        cards = visible_cards()
        if cards == 0:
            raise RuntimeError("no CUDA card is available: pass "
                               "device='cpu' to run on the CPU")
        dev = torch.device("cuda", local_rank % cards)
        torch.cuda.set_device(dev)
    else:
        cards, dev = 0, torch.device("cpu")
    if world % views:
        raise ValueError(f"a world of {world} ranks does not form a grid "
                         f"with {views} views per row")
    if world == 1:
        return DataParallel(device=dev)
    backend = choose_backend(device_type, world, cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    view_group, data_group = _grid_groups(rank, world, views)
    dp = DataParallel(rank=rank, world=world, device=dev,
                      group=dist.group.WORLD, backend=backend, views=views,
                      view_group=view_group, data_group=data_group)
    if dp.is_main:
        logger.info("data parallel: %d ranks (%d data x %d views), backend "
                    "%s (%s)", world, dp.data_world, views, backend,
                    "a card per rank" if backend == "nccl" else
                    "the CPU" if device_type == "cpu" else
                    f"{world} ranks on {cards} card(s)")
    return dp


def _grid_groups(rank: int, world: int, views: int):
    """(this rank's view group, its data group): the ranks of its data
    row and of its view slot, in JAX's mesh order (rank = data_rank *
    views + view_rank). Every rank makes every group, as
    `dist.new_group` requires. A view world of 1 has no view group and
    the world's group as its data group; a single data row has no data
    group."""
    data = world // views
    if views == 1:
        return None, dist.group.WORLD
    view_group = data_group = None
    for d in range(data):
        g = dist.new_group([d * views + v for v in range(views)])
        if rank // views == d:
            view_group = g
    if data > 1:
        for v in range(views):
            g = dist.new_group([d * views + v for d in range(data)])
            if rank % views == v:
                data_group = g
    return view_group, data_group


def close(dp: DataParallel) -> None:
    """Leave the process group (a no-op for a world of 1)."""
    if dp.group is not None:
        dist.destroy_process_group()


def _place(batch, rows: slice, views: slice):
    """`batch` with every leaf cut to `rows` of its batch axis, and the
    leaves under `views` and `view_data`, laid out (B, V, ...), to `views`
    of their view axis; `targets` (B, M, ...) keep every view. A Batch
    field with no rule here raises rather than inherit a wrong
    placement."""
    from mvgformer_tpu_torch.data.meta import map_tensors

    placed = {}
    for f in dataclasses.fields(batch):
        value = getattr(batch, f.name)
        if f.name in ("views", "view_data"):
            placed[f.name] = map_tensors(value, lambda t: t[rows, views])
        elif f.name == "targets":
            placed[f.name] = map_tensors(value, lambda t: t[rows])
        else:
            raise ValueError(
                f"shard_batch: unplaced Batch field {f.name!r}: add an "
                f"explicit placement rule for it in parallel/mesh.py")
    return dataclasses.replace(batch, **placed)


def shard_batch(batch, dp: DataParallel):
    """This rank's shard of a global Batch: rows [data_rank*B,
    (data_rank+1)*B) of every leaf and, under a view split, this rank's
    contiguous views of `views` and `view_data` (`shard_views`). A view
    count that the view world does not divide raises."""
    rows = dp.rows(int(batch.views.shape[0]))
    return _place(batch, rows, dp.view_slice(int(batch.views.shape[1])))


def shard_views(batch, dp: DataParallel):
    """This rank's views of a batch that already holds its rows (every
    view of them), as a data loader gives it: the batch itself without a
    view split."""
    if dp.views == 1:
        return batch
    return _place(batch, slice(None),
                  dp.view_slice(int(batch.views.shape[1])))


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1).float() for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    at = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[at:at + n].view_as(t))
        at += n


def replicated(model: torch.nn.Module, dp: DataParallel) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (one broadcast per
    dtype)."""
    if not dp.distributed:
        return model
    tensors = [*model.parameters(), *model.buffers()]
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            group = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0, group=dp.group)
            _unflat(flat, group)
    return model


def all_reduce_grads(params: Iterable[torch.nn.Parameter], dp: DataParallel,
                     extras: torch.Tensor) -> torch.Tensor:
    """Average the gradients of `params` over the ranks, in place, and
    return the mean over the ranks of `extras` (the step's loss terms).

    `params` is the same list on every rank (the trainable parameters); a
    gradient of None counts as zeros, as the optimizer reads it, so that
    every rank packs the same buffer. The gradients and `extras` go into
    one flat float32 buffer and one all-reduce."""
    if not dp.distributed:
        return extras
    grads = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    n = sum(g.numel() for g in grads)
    with torch.no_grad():
        flat = _flat(grads + [extras])
        dist.all_reduce(flat, group=dp.group)
        flat /= dp.world
        _unflat(flat[:n], grads)
    return flat[n:].view_as(extras)


def reduce_count(num: torch.Tensor, dp: Optional[DataParallel]
                 ) -> torch.Tensor:
    """The mean of a count over the ranks (the count itself without data
    parallelism). The ranks of a data row hold the same targets, so the
    mean over the whole grid is the mean over its data rows."""
    if dp is None or not dp.distributed:
        return num
    total = num.detach().clone()
    dist.all_reduce(total, group=dp.group)
    return total / dp.world


def any_rank(flag: bool, dp: DataParallel) -> bool:
    """Whether `flag` holds on any rank (a preemption request)."""
    if not dp.distributed:
        return flag
    t = torch.tensor([int(flag)], device=dp.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=dp.group)
    return bool(t.item())


def gather_objects(obj, dp: DataParallel) -> list:
    """Every rank's `obj` (picklable host data), in rank order."""
    if not dp.distributed:
        return [obj]
    out = [None] * dp.world
    dist.all_gather_object(out, obj, group=dp.group)
    return out


def broadcast_object(obj, dp: DataParallel):
    """Rank 0's `obj` on every rank."""
    if not dp.distributed:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=dp.group)
    return box[0]


def _worker(rank: int, fn: Callable, world: int, device: str,
            store: str, result_path: str, args: tuple, views: int) -> None:
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    dp = init_data_parallel(world // views, device, rank=rank, world=world,
                            init_method=f"file://{store}", views=views)
    try:
        result = fn(dp, *args)
        if dp.is_main:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        close(dp)


def spawn(fn: Callable, world: int, device, *args, views: int = 1):
    """Run `fn(dp, *args)` on `world` ranks in spawned processes that meet
    at a file store in a temporary directory, and return rank 0's result;
    with `views` > 1 the ranks form a (world / views) x views grid. On the
    card rank r takes cuda:(r % visible cards), so ranks may share a card
    (over gloo). `fn` must be importable (spawn pickles it by name) and
    its result picklable."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="mvg-dp-") as tmp:
        store = os.path.join(tmp, "store")
        result_path = os.path.join(tmp, "result.pkl")
        mp.start_processes(_worker, args=(fn, world, str(device), store,
                                          result_path, args, views),
                           nprocs=world, join=True, start_method="spawn")
        with open(result_path, "rb") as f:
            return pickle.load(f)


def launch(fn: Callable, num: int, device, *args, views: int = 1):
    """Run `fn(dp, *args)` on every rank of the grid, `num` data rows (as
    PARALLEL.DATA asks) x `views` view ranks, and return rank 0's result:
    in this process for a world of 1 or under torchrun (joining its
    group), else in spawned processes (`spawn`). The data rows are
    `data_world(num, device)`; under a view split `num` rows exactly (-1
    or 0: one), their ranks sharing the visible cards."""
    device = str(device)
    if under_torchrun():
        world = 1
    elif views > 1:
        world = max(num, 1) * views
    else:
        world = data_world(num, device)
    if world > 1:
        return spawn(fn, world, device, *args, views=views)
    dp = init_data_parallel(num, device, views=views)
    try:
        return fn(dp, *args)
    finally:
        close(dp)
