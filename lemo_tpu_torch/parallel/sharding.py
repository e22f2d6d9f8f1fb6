"""Scale-out on `torch.distributed`, one process per card (port of
`lemo_tpu/parallel/sharding.py`).

`lemo_tpu` is one controller over many devices: it places arrays on a
`jax.sharding.Mesh` and XLA inserts the collectives. Every fit of the
port is host-bound (one eager launch after another), so one process
driving n cards would serialise their dispatch on one thread. Here each
card has its own process: each rank dispatches its own shard, and
collectives join the results. The axes sharded are `lemo_tpu`'s:

- prior training: data-parallel batches (`data_parallel_step`:
  parameters and optimizer state replicated, the gradient all-reduced);
- AMASS fitting: the clip axis of the folded Stage 2
  (`clip_sharded_fit`), the frame axis of the parallel Stage 1
  (`frame_sharded_fit`);
- PROX: the window axis of the window-parallel fit
  (`fitting.prox.window.make_batched_window_fitter(mesh=...)`).

A rank's shard of n rows is `torch.tensor_split`'s: the first n % size
ranks take one row more. The collectives are `all_reduce(SUM)` and
`broadcast` only, the two that gloo also runs on CUDA tensors (two
ranks on one card need gloo: NCCL refuses them). A gather is an
all-reduce of a buffer filled with -0.0 into which each rank has written
its own rows: -0.0 is the exact additive identity of IEEE floats
(x + -0.0 = x for every x, -0.0 and NaN included), so the gathered rows
are each rank's bits.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from lemo_tpu_torch.fitting.adam import _flatten, _unflatten, adam_step


def default_backend(device_type: str) -> str:
    """The process-group backend for ranks on `device_type`: nccl on
    CUDA, gloo on the CPU. Gloo on CUDA is what a caller asks for; it is
    never taken as a fallback."""
    return "nccl" if device_type == "cuda" else "gloo"


def shard_bounds(n: int, size: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of rank `rank`'s share of n rows among `size` ranks, as
    `torch.tensor_split(x, size)[rank]` takes them."""
    q, r = divmod(int(n), int(size))
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def shard_owner(n: int, size: int, i: int) -> int:
    """The rank whose `shard_bounds` share of n rows holds row i."""
    q, r = divmod(int(n), int(size))
    return i // (q + 1) if i < r * (q + 1) else r + (i - r * (q + 1)) // q


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks that share a piece of work: the process group, this
    rank's index in it (-1 where the rank is not a member), the rank's
    device, and the named axes. `group` None is a one-rank mesh with no
    process group (nothing initialised); a mesh of named dimensions keeps
    its `torch.distributed.device_mesh.DeviceMesh`."""

    group: Any
    rank: int
    size: int
    device: torch.device
    axis_names: tuple[str, ...] = ("dp",)
    shape: tuple[int, ...] = (1,)
    device_mesh: Any = None

    def along(self, axis_name: str) -> "Mesh":
        """The 1-D mesh of this rank's group along `axis_name`."""
        if axis_name not in self.axis_names:
            raise ValueError(f"no axis {axis_name!r} in {self.axis_names}")
        if len(self.axis_names) == 1:
            return self
        if self.device_mesh is None:
            return dataclasses.replace(self, axis_names=(axis_name,),
                                       shape=(1,))
        dm = self.device_mesh
        return Mesh(dm.get_group(axis_name), dm.get_local_rank(axis_name),
                    dm.size(self.axis_names.index(axis_name)), self.device,
                    (axis_name,), (dm.size(self.axis_names.index(axis_name)),))

    def rows(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's share of n rows."""
        if self.rank < 0:
            raise ValueError("this rank is not a member of the mesh")
        return shard_bounds(n, self.size, self.rank)

    def global_rank(self, index: int) -> int:
        """The default group's rank of the mesh's rank `index`."""
        if self.group is None:
            return 0
        return dist.get_global_rank(self.group, index)


def _rank_device(device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_devices: int | None = None, axis_name: str = "dp",
              device=None) -> Mesh:
    """A 1-D mesh over the initialised default group, or over its first
    `n_devices` ranks (every rank must call it: the subgroup is created
    collectively). With no group initialised it is a one-rank mesh on
    `device` (None: the current CUDA card, else the CPU)."""
    dev = _rank_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh({n_devices}): no process group is "
                             "initialised (initialize_multihost)")
        return Mesh(None, 0, 1, dev, (axis_name,), (1,))
    world = dist.get_world_size()
    n = int(n_devices or world)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh({n_devices}): {world} ranks")
    if n == world:
        return Mesh(dist.group.WORLD, dist.get_rank(), n, dev, (axis_name,),
                    (n,))
    group = dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh(group, rank if rank < n else -1, n, dev, (axis_name,), (n,))


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device=None) -> int:
    """Initialise the default process group, one process per card, and
    return this process's rank (a no-op returning 0 with one process and
    no coordinator, or the rank when a group is already up).

    Under `torchrun` the arguments come from the environment (`RANK`,
    `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`/`MASTER_PORT`); elsewhere
    pass them: `coordinator_address` is `host:port` (TCP) or an init
    method URL (`tcp://...`, `file:///path` for a shared file store).
    The rank's device is `device`, else `cuda:LOCAL_RANK` (LOCAL_RANK
    defaults to the rank modulo the cards), else the CPU; on CUDA it is
    made the current device, since the kernel wrappers launch on the
    current device's stream. `backend` None takes `default_backend` of
    that device.
    """
    if dist.is_initialized():
        return dist.get_rank()
    env = os.environ
    world = int(num_processes if num_processes is not None
                else env.get("WORLD_SIZE", 1))
    if world <= 1 and coordinator_address is None:
        return 0
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if device is None and torch.cuda.is_available():
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    dev = _rank_device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend or default_backend(dev.type),
                            init_method=init_method, world_size=world,
                            rank=rank)
    return rank


def _local_world_size() -> int:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def make_pod_mesh(dp: int | None = None, within: int | None = None,
                  axis_names: tuple[str, str] = ("dp", "win")) -> Mesh:
    """2-D mesh over all ranks: an outer `dp` axis for independent work
    (recordings, clips; across hosts) and an inner `within` axis for
    work that communicates (windows of one recording, frame-sharded
    fits; within a host). Defaults: dp = the number of hosts
    (WORLD_SIZE / LOCAL_WORLD_SIZE, 1 locally), within = the rest.
    Raises ValueError when dp * within is not the number of ranks."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if dp is None:
        dp = max(n // _local_world_size(), 1)
    if within is None:
        within = n // dp
    if dp * within != n:
        raise ValueError(f"dp*within = {dp}*{within} != {n} ranks")
    dev = _rank_device()
    if n == 1:
        return Mesh(None, 0, 1, dev, tuple(axis_names), (dp, within))
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (dp, within),
                          mesh_dim_names=tuple(axis_names))
    return Mesh(dist.group.WORLD, dist.get_rank(), n, dev, tuple(axis_names),
                (dp, within), dm)


# --- collectives -----------------------------------------------------------

def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The dtype a leaf travels in (bool as uint8)."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _packed(tree, collective):
    """`collective(buffer)` (in place) on one flat buffer a (dtype,
    device) of `tree`'s tensors; the tree rebuilt from the buffers (new
    tensors)."""
    leaves = _leaves(tree)
    out = [None] * len(leaves)
    by_dtype: dict = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault((_wire(x).dtype, x.device), []).append(i)
    for idx in by_dtype.values():
        buf = torch.cat([_wire(leaves[i]).reshape(-1) for i in idx])
        collective(buf)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            out[i] = buf[off:off + n].reshape(leaves[i].shape).to(
                leaves[i].dtype)
            off += n
    return _rebuild(tree, iter(out))


def all_reduce_sum(mesh: Mesh, tree):
    """Every tensor of `tree` summed over the mesh's ranks (new tensors;
    one collective a dtype)."""
    if mesh.group is None:
        return tree
    return _packed(tree, lambda b: dist.all_reduce(b, group=mesh.group))


def gather_rows(mesh: Mesh, tree, n: int, bounds: tuple | None = None):
    """Every tensor of `tree` holds this rank's rows of an [n, ...] array
    (`mesh.rows(n)`, or `bounds` [lo, hi) where the ranks split the rows
    otherwise); returns the [n, ...] arrays on every rank, each row with
    its owner's bits (one all-reduce a dtype of a buffer filled with -0.0
    or 0)."""
    lo, hi = bounds or mesh.rows(n)
    leaves = _leaves(tree)
    for x in leaves:
        if x.shape[0] != hi - lo:
            raise ValueError(f"gather_rows: a leaf has {x.shape[0]} rows, "
                             f"this rank's share of {n} is {hi - lo}")
    if mesh.group is None:
        return tree
    full = []
    for x in leaves:
        fill = -0.0 if x.is_floating_point() else 0
        buf = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                         device=x.device)
        buf[lo:hi] = x
        full.append(buf)
    return all_reduce_sum(mesh, _rebuild(tree, iter(full)))


def any_rank(mesh: Mesh, flag: torch.Tensor) -> torch.Tensor:
    """A bool tensor OR-ed over the mesh's ranks (one all-reduce of its
    f32 count, on the device; the flag itself with no process group)."""
    if mesh.group is None:
        return flag
    return all_reduce_sum(mesh, flag.to(torch.float32)) > 0


def broadcast_tree(mesh: Mesh, tree, src: int = 0):
    """`tree` as the mesh's rank `src` holds it, on every rank (new
    tensors). The other ranks pass a tree of the same structure, shapes
    and dtypes, whose values are ignored."""
    if mesh.group is None:
        return tree
    return _packed(tree, lambda b: dist.broadcast(
        b, src=mesh.global_rank(src), group=mesh.group))


def owned_rows(mesh: Mesh, x, n: int):
    """This rank's rows of `x` when it holds all n, else `x` itself when
    it holds just this rank's share (raises on any other count)."""
    lo, hi = mesh.rows(n)
    if x.shape[0] == n:
        return x[lo:hi]
    if x.shape[0] == hi - lo:
        return x
    raise ValueError(f"{x.shape[0]} rows: neither all {n} nor this rank's "
                     f"{hi - lo}")


# --- the sharded entry points ----------------------------------------------

def data_parallel_step(train_step, mesh: Mesh, axis_name: str = "dp"):
    """Wrap a trainer's `train_step(params, state, batch, *rest) ->
    (params, metrics)` (the port's trainers: `train_step.loss_fn` is the
    loss it differentiates, `train_step.lr` its Adam rate) so that the
    batch is sharded over the mesh's `axis_name` and the parameters and
    Adam state are replicated:

    1. the parameters and the Adam state are broadcast from rank 0;
    2. each rank takes its `tensor_split` rows of the batch and of every
       tensor in `rest` with the batch's leading size (the infill
       prior's masks, VPoser's noise);
    3. each rank differentiates its rows' loss weighted by its share of
       the rows, so that the sum over ranks is the full-batch mean (the
       trainers' losses are means over rows);
    4. the gradients and the metrics are summed over the ranks
       (`all_reduce`);
    5. every rank runs the same `adam_step`.

    The returned step keeps the last summed gradients in `last_grads`
    ({path tuple: tensor})."""
    m = mesh.along(axis_name)

    def step(params, state, batch, *rest):
        flat = dict(_flatten(params))
        if m.group is not None:
            flat, mu, nu = broadcast_tree(m, (flat, state.mu, state.nu))
            state.mu, state.nu = mu, nu
        B = batch.shape[0]
        lo, hi = m.rows(B)
        rest = tuple(r[lo:hi] if torch.is_tensor(r) and r.dim() >= 1
                     and r.shape[0] == B else r for r in rest)
        leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
        loss, metrics = train_step.loss_fn(_unflatten(leaves), batch[lo:hi],
                                           *rest)
        share = (hi - lo) / B
        grads = torch.autograd.grad(loss * share, list(leaves.values()))
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   "total": loss.detach()}
        grads, metrics = all_reduce_sum(
            m, (list(grads), {k: v * share for k, v in metrics.items()}))
        grads = dict(zip(leaves, grads))
        step.last_grads = grads
        new = adam_step(leaves, grads, state, train_step.lr)
        return _unflatten(new), metrics

    step.last_grads = None
    return step


def clip_sharded_fit(fit_fn, mesh: Mesh, axis_name: str = "dp"):
    """Shard a batched fit `fit(*batched) -> outputs` over clips: every
    argument's leading axis is the clip axis C, each rank fits its
    `tensor_split` share of the clips, and every rank gets the outputs
    (tensors with C leading) gathered back to [C, ...].

    It accepts the fused fold (`make_temporal_fitter_batched`'s
    default). `lemo_tpu` refuses it under a mesh because GSPMD gathers
    the operands of the opaque `pallas_call` to one device; here nothing
    gathers a kernel's operands: each rank runs the kernels on its own
    clips. Needs at least one clip a rank."""
    m = mesh.along(axis_name)

    def run(*batched):
        C = batched[0].shape[0]
        if C < m.size:
            raise ValueError(f"{C} clips on {m.size} ranks: at least one "
                             "clip a rank")
        lo, hi = m.rows(C)
        return gather_rows(m, fit_fn(*(b[lo:hi] for b in batched)), C)

    return run


def shard_frames(mesh: Mesh, pytree, axis_name: str = "dp"):
    """This rank's `tensor_split` share of a per-frame tree (leading axis
    = frames): the sequence-parallel layout of the temporal fits."""
    m = mesh.along(axis_name)
    n = _leaves(pytree)[0].shape[0]
    lo, hi = m.rows(n)
    return _rebuild(pytree, iter([x[lo:hi] for x in _leaves(pytree)]))


def frame_sharded_fit(fit_fn, mesh: Mesh, axis_name: str = "dp"):
    """Shard the frames of a per-frame fit (the parallel Stage 1,
    `fitting.amass_perframe.make_stage1_fitter`): `fit(frames, *rest,
    frames_total=T, reduce_dead=f) -> (per-frame [T_rank, ...], per-step
    losses [S])`, where the losses are this rank's share of the mean
    over all T frames and `f` combines the fit's freeze flag over the
    ranks (`run_adam(reduce_dead=...)`). Returns `run(frames, *rest) ->
    ([T, ...], [S])`: the per-frame rows gathered and the losses summed
    over the ranks, on every rank. A rank's frames are its
    `tensor_split` share of the ceil(T / b) blocks of
    `fit_fn.frame_block` = b frames (1 without one), so that a fitter
    that computes in blocks (the Stage-1 decode on the card) computes
    each frame as unsharded. Frames are independent and Adam is
    elementwise, so each rank's frames follow the unsharded fit's
    trajectory. The unsharded fit freezes whole when its loss, the sum
    of the ranks' shares, goes NaN/Inf (`lemo_tpu/fitting/adam.py:
    66-71`); here the ranks OR their flags each step (`any_rank`, one
    all-reduce a step), so a NaN/Inf in any rank's share freezes every
    rank at that step."""
    m = mesh.along(axis_name)
    block = int(getattr(fit_fn, "frame_block", 1))

    def run(frames, *rest):
        T = frames.shape[0]
        n_blocks = -(-T // block)
        if n_blocks < m.size:
            raise ValueError(f"{T} frames ({n_blocks} blocks of {block}) "
                             f"on {m.size} ranks")
        b_lo, b_hi = m.rows(n_blocks)
        lo, hi = b_lo * block, min(b_hi * block, T)
        out, losses = fit_fn(frames[lo:hi], *rest, frames_total=T,
                             reduce_dead=lambda dead: any_rank(m, dead))
        return gather_rows(m, out, T, (lo, hi)), all_reduce_sum(m, losses)

    return run
