"""The mesh of ranks (counterpart of ``doc2tex_tpu.parallel.mesh``).

The JAX package places arrays on a 2-axis ``("data", "model")`` device mesh
and lets XLA insert the collectives.  The port runs one process per device
(a rank) under ``torch.distributed`` and does by hand what XLA does there:

- ``data``: the batch axis.  Each data rank holds its rows of the global
  batch (``shard_batch``); whatever the JAX program computes over the whole
  batch is reduced over the data group: BatchNorm's training statistics,
  the int8 encoder's activation abs-max, the loss's numerator and count and
  the gradients.  Random draws are made at the global batch's shape and
  each rank keeps its rows (``batch_rows``, ``rand``), so a sharded step
  draws what one device draws.
- ``model``: the JAX package shards every large weight over it
  (``_param_spec``), which changes where bytes live, not the function.  In
  the port the model axis replicates: the ranks of one data row hold every
  weight and compute the same rows, so no collective crosses the axis
  (``param_shardings`` still gives JAX's placement; storing weights by
  columns is ROADMAP A10).

A ``Mesh`` is a (data x model) grid of ranks, rank ``d * n_model + m`` at
(d, m), with its two process groups and the rank's device.  Ranks on cards
of their own use NCCL; ranks that share a card, or run on the CPU, use gloo,
and a CUDA tensor goes through the host for a gloo collective.

Two ways to run the ranks:

- SPMD (training): every rank runs the same program on the same global
  batch (``spawn``, or torchrun's environment through ``join_from_env``).
- Single controller (inference and serving): rank 0 runs the caller's code,
  and ``lead`` starts the other ranks, which build the same objects and
  then ``Mesh.follow``.  A sharded function built with ``Mesh.register`` is
  called on rank 0 only: it broadcasts its arrays' shapes and bytes, and
  every rank runs the function on them (each on its rows).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import math
import multiprocessing
import os
import pickle
import shutil
import sys
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
DEFAULT_TIMEOUT_S = 1800          # a collective (and the start-up rendezvous) waits this long
FOLLOWER_TIMEOUT_S = 30 * 86400   # a serving follower may wait this long for rank 0's next call
PARENT_POLL_S = 0.5               # a follower looks this often whether rank 0's process lives
SHUTDOWN_LIMIT_S = 60             # a follower's exit after rank 0's shutdown

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Process groups

_STATE: dict = {"device": None, "backend": None, "timeout_s": DEFAULT_TIMEOUT_S}


def pick_backend(devices: Sequence) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def start(rank: int, world: int, init_method: str, device, backend: str,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group as ``rank`` of ``world`` on ``device``."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _STATE.update(device=device, backend=backend, timeout_s=timeout_s)
    if rank == 0:
        print(f"mesh: {world} ranks over {backend}", file=sys.stderr, flush=True)


def join_from_env(timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group that torchrun's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT); False when there is none or
    the group is up already.  Rank r takes card LOCAL_RANK, NCCL when the
    node has a card for each local rank."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    local = int(os.environ.get("LOCAL_RANK", 0))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards:
        device = torch.device("cuda", local % n_cards)
        backend = "nccl" if local_world <= n_cards else "gloo"
    else:
        device, backend = torch.device("cpu"), "gloo"
    start(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), "env://", device, backend,
          timeout_s)
    return True


def stop() -> None:
    """Leave the process group (and forget its meshes)."""
    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, backend=None, timeout_s=DEFAULT_TIMEOUT_S)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank_device(default="cuda") -> torch.device:
    """The device ``start`` gave this rank, else ``default``."""
    return _STATE["device"] if _STATE["device"] is not None else torch.device(default)


# ---------------------------------------------------------------------------
# The mesh

class Mesh:
    """A (data x model) grid of ranks: ``shape``, this rank's ``rank``,
    ``data_index`` and ``model_index``, its ``device``, the ``backend`` and
    the process groups of its data and model axes."""

    def __init__(self, nd: int, nm: int, rank: int, device, backend: Optional[str],
                 groups: dict):
        self.shape = {DATA_AXIS: nd, MODEL_AXIS: nm}
        self.size = nd * nm
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, nm)
        self.device = torch.device(device)
        self.backend = backend
        self._groups = groups          # axis (None: every rank) -> process group
        self._handlers: dict[str, Callable] = {}
        self._counts: dict[str, int] = {}
        self._lock = threading.RLock()
        self._followers: list = []
        self._tmp: Optional[str] = None   # lead's rendezvous directory
        self._watching: Optional[threading.Event] = None   # set: lead's watch ends

    def __repr__(self):
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"rank={self.rank}, device={self.device}, backend={self.backend})")

    @property
    def nd(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def nm(self) -> int:
        return self.shape[MODEL_AXIS]

    def rows(self, n: int) -> slice:
        """This data rank's rows of a global batch of ``n`` (n % nd == 0)."""
        if n % self.nd:
            raise ValueError(f"a batch of {n} does not split over {self.nd} data ranks "
                             "(pad it to a multiple first)")
        b = n // self.nd
        return slice(self.data_index * b, (self.data_index + 1) * b)

    def columns(self, n: int) -> slice:
        """This model rank's share of an axis of ``n`` (n % nm == 0)."""
        b = n // self.nm
        return slice(self.model_index * b, (self.model_index + 1) * b)

    # ---- collectives (no autograd) ------------------------------------
    def axis_size(self, axis) -> int:
        return self.size if axis is None else self.shape[axis]

    def _comm(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: gloo collectives go through the
        host, NCCL's through the rank's card."""
        t = t.contiguous()
        if self.backend == "gloo" and t.is_cuda:
            return t.cpu()
        if self.backend == "nccl" and not t.is_cuda:
            return t.to(self.device)
        return t

    def all_reduce(self, t: torch.Tensor, axis=DATA_AXIS, op: str = "sum") -> torch.Tensor:
        """A new tensor: ``t`` summed (``op`` "sum") or maxed ("max") over
        the ranks of ``axis``."""
        if self.axis_size(axis) == 1:
            return t
        c = self._comm(t)
        c = c.clone() if c is t else c
        dist.all_reduce(c, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX,
                        group=self._groups[axis])
        return c.to(t.device)

    def all_gather(self, t: torch.Tensor, axis=DATA_AXIS, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in
        the order of the axis."""
        g = self.axis_size(axis)
        if g == 1:
            return t
        c = self._comm(t)
        parts = [torch.empty_like(c) for _ in range(g)]
        dist.all_gather(parts, c, group=self._groups[axis])
        return torch.cat(parts, dim=dim).to(t.device)

    def gather_rows(self, t: torch.Tensor, axis=DATA_AXIS, fill=0) -> torch.Tensor:
        """Every rank's rows of ``t`` concatenated along dim 0; where the
        ranks' other dims differ (decode loops that stopped at other steps)
        each is padded with ``fill`` to the largest."""
        g = self.axis_size(axis)
        if g == 1:
            return t
        sizes = self.all_gather(torch.tensor([list(t.shape)], dtype=torch.long), axis)
        full = sizes.max(dim=0).values.tolist()
        if list(t.shape[1:]) != full[1:]:
            pad = []
            for have, want in zip(reversed(t.shape[1:]), reversed(full[1:])):
                pad += [0, want - have]
            t = torch.nn.functional.pad(t, pad, value=fill)
        return self.all_gather(t, axis)

    # ---- single controller --------------------------------------------
    def register(self, name: str, fn: Callable) -> Callable:
        """Make ``fn(*tensors)`` (an SPMD function: every rank calls it
        with the same arguments) callable from rank 0 alone: the returned
        function broadcasts its arguments' shapes and bytes and runs ``fn``
        on every rank; the other ranks run it from ``follow``.  Every rank
        registers the same functions in the same order (a name's n-th
        registration has the key ``name:n``)."""
        n = self._counts.get(name, 0)
        self._counts[name] = n + 1
        key = f"{name}:{n}"
        self._handlers[key] = fn
        if self.size == 1:
            return fn

        def lead(*arrays):
            if self.rank != 0:
                raise RuntimeError(f"{key}: rank {self.rank} follows; only rank 0 calls")
            tensors = [a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
                       for a in arrays]
            with self._lock:   # one call in flight: the followers take them in order
                self._send(key, tensors)
                return fn(*tensors)

        return lead

    def _object_device(self):
        return self.device if self.backend == "nccl" else None

    def _send(self, key: Optional[str], tensors: Sequence[torch.Tensor]) -> None:
        # the header on the default group, whose wait (a follower idles until
        # the next call) is unbounded under ``lead``; the bytes on the mesh's
        # own group, which waits DEFAULT_TIMEOUT_S
        header = [(key, [(tuple(t.shape), str(t.dtype).split(".")[-1]) for t in tensors])]
        dist.broadcast_object_list(header, src=0, device=self._object_device())
        for t in tensors:
            dist.broadcast(self._comm(t), src=0, group=self._groups[None])

    def follow(self) -> None:
        """On a rank other than 0: run the calls rank 0 makes, in order,
        until ``stop_followers``."""
        comm = self.device if self.backend == "nccl" else torch.device("cpu")
        while True:
            header = [None]
            dist.broadcast_object_list(header, src=0, device=self._object_device())
            key, specs = header[0]
            if key is None:
                return
            tensors = []
            for shape, dtype in specs:
                t = torch.empty(shape, dtype=getattr(torch, dtype), device=comm)
                dist.broadcast(t, src=0, group=self._groups[None])
                tensors.append(t)
            self._handlers[key](*tensors)

    def stop_followers(self) -> None:
        """Rank 0: end the other ranks' ``follow`` loops."""
        if self.size > 1 and self.rank == 0:
            with self._lock:
                self._send(None, [])

    def shutdown(self) -> None:
        """Rank 0 of ``lead``: stop the followers, wait for their processes
        and leave the process group."""
        procs, self._followers = self._followers, []
        if self._watching is not None:
            self._watching.set()
        if procs:
            self.stop_followers()
            dist.barrier()
        for p in procs:
            p.join(SHUTDOWN_LIMIT_S)
            if p.is_alive():
                p.kill()
        stop()
        if self._tmp:
            shutil.rmtree(self._tmp, ignore_errors=True)
        bad = [p.exitcode for p in procs if p.exitcode]
        if bad:
            raise RuntimeError(f"a follower rank ended with exit code {bad[0]}")


_MESHES: dict = {}


def make_mesh(mesh_shape: Optional[dict] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The ``(data, model)`` mesh over the ranks of the process group (one
    rank per device; without a group, this process alone).  ``mesh_shape``
    e.g. ``{"data": 4, "model": 2}``; the default puts every rank on the
    data axis.  ``devices`` (one per rank) must number the ranks.  Every
    rank makes the same meshes in the same order (the groups are
    collective)."""
    world = world_size()
    n = len(devices) if devices is not None else world
    if n != world:
        raise ValueError(f"{n} devices but {world} ranks: the port runs one rank per device "
                         "(start them with parallel.spawn, parallel.lead or torchrun)")
    if mesh_shape:
        nd, nm = int(mesh_shape.get(DATA_AXIS, 1)), int(mesh_shape.get(MODEL_AXIS, 1))
        if nd * nm != n:
            raise ValueError(f"mesh {mesh_shape} != {n} devices")
    else:
        nd, nm = n, 1
    rank = dist.get_rank() if world > 1 else 0
    device = torch.device(devices[rank]) if devices is not None else rank_device(
        "cuda" if torch.cuda.is_available() else "cpu")
    key = (nd, nm, str(device))
    if key in _MESHES:
        return _MESHES[key]
    groups: dict = {None: None, DATA_AXIS: None, MODEL_AXIS: None}
    if world > 1:
        # the mesh's collectives wait DEFAULT_TIMEOUT_S, also where the
        # default group waits longer (``lead``'s followers idle on it)
        timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
        own = _STATE["timeout_s"] > DEFAULT_TIMEOUT_S
        groups[None] = dist.new_group(list(range(world)), timeout=timeout) if own \
            else dist.group.WORLD
        for axis, members in ((DATA_AXIS, [[d * nm + m for d in range(nd)] for m in range(nm)]),
                              (MODEL_AXIS, [[d * nm + m for m in range(nm)] for d in range(nd)])):
            if len(members[0]) == world:
                groups[axis] = groups[None]
                continue
            for ranks in members:   # every rank makes every group, in this order
                g = dist.new_group(ranks, timeout=timeout) if len(ranks) > 1 else None
                if rank in ranks:
                    groups[axis] = g
    mesh = Mesh(nd, nm, rank, device, _STATE["backend"], groups)
    _MESHES[key] = mesh
    return mesh


# ---------------------------------------------------------------------------
# Shardings: the JAX package's placement rules, as specs over shapes

class NamedSharding(NamedTuple):
    """A spec (a tuple: an axis name or None per dim, () = replicated) on a
    mesh, as ``jax.sharding.NamedSharding`` names one."""
    mesh: Mesh
    spec: tuple


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis (batch) sharding over the data axis."""
    return NamedSharding(mesh, (DATA_AXIS,))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _param_spec(path: str, p, n_model: int, min_size: int) -> tuple:
    """The JAX package's rule for one parameter of shape ``p.shape``:
    a weight of at least 2 dims and ``min_size`` elements shards its last
    dim over ``model`` where it divides, else its second-to-last; the rest
    is replicated (``()``)."""
    shape = tuple(p.shape)
    ndim = len(shape)
    if n_model <= 1 or ndim < 2 or math.prod(shape) < min_size:
        return ()
    if shape[-1] % n_model == 0:
        return (None,) * (ndim - 1) + (MODEL_AXIS,)
    if shape[-2] % n_model == 0:
        return (None,) * (ndim - 2) + (MODEL_AXIS, None)
    return ()


def _tree_map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params: Any, mesh: Mesh, min_size: int = 2**16) -> Any:
    """A ``NamedSharding`` per leaf of a parameter tree (nested dicts of
    arrays or tensors), by ``_param_spec``."""
    return _tree_map(lambda path, p: NamedSharding(
        mesh, _param_spec("/".join(map(str, path)), p, mesh.nm, min_size)), params)


def _local(x, spec: tuple, mesh: Mesh):
    for dim, axis in enumerate(spec):
        if axis == MODEL_AXIS:
            sl = mesh.columns(x.shape[dim])
            x = x[(slice(None),) * dim + (sl,)]
        elif axis == DATA_AXIS:
            sl = mesh.rows(x.shape[dim])
            x = x[(slice(None),) * dim + (sl,)]
    return x


def shard_params(params: Any, mesh: Mesh, min_size: int = 2**16) -> Any:
    """Each leaf's share on this rank under ``param_shardings``."""
    return _tree_map(lambda path, p: _local(p, _param_spec("", p, mesh.nm, min_size), mesh),
                     params)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This data rank's rows of every leaf of ``batch`` (numpy arrays or
    tensors).  Pads nothing: the leading dim must divide over the data
    axis."""
    return _tree_map(lambda path, x: x[mesh.rows(x.shape[0])], batch)


def pad_rows(x, multiple: int, value=255):
    """``x`` (numpy or tensor) with rows of ``value`` appended up to a
    multiple of ``multiple`` (white images, for the eval tails)."""
    extra = -x.shape[0] % multiple
    if not extra:
        return x
    if torch.is_tensor(x):
        return torch.cat([x, torch.full((extra, *x.shape[1:]), value, dtype=x.dtype,
                                        device=x.device)])
    return np.concatenate([x, np.full((extra, *x.shape[1:]), value, x.dtype)])


# ---------------------------------------------------------------------------
# Activation boundaries

_ACTIVATION_MESH: list = []


class activation_mesh:
    """``with activation_mesh(mesh): ...``: the model code below reduces
    and gathers over ``mesh`` (None: no-op)."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh

    def __enter__(self):
        if self.mesh is not None:
            _ACTIVATION_MESH.append(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        if self.mesh is not None:
            _ACTIVATION_MESH.pop()
        return False


def current_activation_mesh() -> Optional[Mesh]:
    return _ACTIVATION_MESH[-1] if _ACTIVATION_MESH else None


_DROP_WARNED: set = set()


def _warn_dropped_axes(spec, fixed, shape) -> None:
    """Once per (spec, shape): a requested model axis was dropped because
    the dim does not divide, so that boundary stays replicated."""
    key = (spec, fixed, tuple(shape))
    if key in _DROP_WARNED:
        return
    _DROP_WARNED.add(key)
    logger.warning("shard_activation: dropped mesh axes %s for array shape %s "
                   "(dim not divisible by mesh axis size); using %s",
                   [a for a, b in zip(spec, fixed) if a != b], tuple(shape), fixed)


def _fixed_spec(mesh: Mesh, shape, spec) -> tuple:
    fixed = tuple(a if a != MODEL_AXIS or shape[i] % mesh.nm == 0 else None
                  for i, a in enumerate(spec))
    if fixed != tuple(spec):
        _warn_dropped_axes(tuple(spec), fixed, shape)
    return fixed


def shard_activation(x: torch.Tensor, spec: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` as ``spec`` places it on the active mesh: its data rows are
    this rank's already (the caller split the batch), and a ``model`` dim
    gives this model rank's share.  A model axis that does not divide its
    dim is dropped (with a warning, once).  No active mesh: ``x`` itself."""
    mesh = current_activation_mesh()
    if mesh is None:
        return x
    fixed = _fixed_spec(mesh, x.shape, spec)
    return _local(x, tuple(a if a == MODEL_AXIS else None for a in fixed), mesh)


# ---- collectives with autograd ----------------------------------------

class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, axis=DATA_AXIS, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """``x`` summed over ``axis`` of ``mesh`` (the active one by default),
    with a gradient that is summed back over it."""
    mesh = mesh or current_activation_mesh()
    if mesh is None or mesh.axis_size(axis) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x, mesh, axis)
    return mesh.all_reduce(x, axis)


def data_all_reduce_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` maxed over the active mesh's data axis (no gradient)."""
    mesh = current_activation_mesh()
    if mesh is None or mesh.nd == 1:
        return x
    return mesh.all_reduce(x, DATA_AXIS, op="max")


def data_size() -> int:
    """The active mesh's data-axis size (1 without one)."""
    mesh = current_activation_mesh()
    return 1 if mesh is None else mesh.nd


# ---- the global batch's random draws -----------------------------------

_ROWS: list = []


@contextlib.contextmanager
def batch_rows(mesh: Optional[Mesh], n_global: int):
    """While active, ``rand`` of a shape whose first dim is this rank's
    row count draws at the global batch's shape and keeps this rank's
    rows: a data rank draws what one device draws for its rows."""
    if mesh is None or mesh.nd == 1:
        yield
        return
    sl = mesh.rows(n_global)
    _ROWS.append((n_global, sl.start, sl.stop))
    try:
        yield
    finally:
        _ROWS.pop()


def rand(shape, generator=None, device=None) -> torch.Tensor:
    """``torch.rand(shape)``, or under ``batch_rows`` this rank's rows of
    the global batch's draw."""
    shape = tuple(shape)
    if _ROWS and shape:
        n, lo, hi = _ROWS[-1]
        if shape[0] == hi - lo:
            return torch.rand((n, *shape[1:]), generator=generator, device=device)[lo:hi]
    return torch.rand(shape, generator=generator, device=device)


# ---------------------------------------------------------------------------
# Launching ranks

def _mp():
    return multiprocessing.get_context("spawn")


def _rank_entry(rank, world, init_method, devices, backend, timeout_s, threads, fn, args,
                result_dir):
    try:
        if threads:
            torch.set_num_threads(threads)
        if world > 1:
            start(rank, world, init_method, devices[rank], backend, timeout_s)
        else:
            _STATE.update(device=torch.device(devices[rank]), backend=None)
        out = fn(*args)
        with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        if world > 1:
            dist.barrier()
        stop()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()


def _kill(procs) -> None:
    started = [p for p in procs if p.pid is not None]   # a failed start leaves the rest unstarted
    for p in started:
        if p.is_alive():
            p.kill()
    for p in started:
        p.join(10)


def spawn(fn: Callable, devices: Sequence, args: tuple = (), time_limit: Optional[float] = None,
          init_method: Optional[str] = None, threads: Optional[int] = None) -> list:
    """Run ``fn(*args)`` on ``len(devices)`` ranks, rank r a spawned
    process on ``devices[r]`` (``threads`` torch threads where given); more
    than one rank start their process group (``init_method`` defaults to a
    ``file://`` in a new temporary directory).  ``fn`` and its arguments
    must pickle.  Returns every rank's return value.  A rank that fails, or
    a group that outlasts ``time_limit`` seconds, kills every rank and
    raises."""
    world = len(devices)
    backend = pick_backend(devices)
    tmp = tempfile.mkdtemp(prefix="d2t_mesh_")
    if world == 1:
        init_method = None
    elif init_method is None:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = _mp()
    procs = [ctx.Process(target=_rank_entry, args=(r, world, init_method, list(devices), backend,
                                                    DEFAULT_TIMEOUT_S, threads, fn, args, tmp),
                         daemon=False)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = None if time_limit is None else time.monotonic() + time_limit
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
            if failed:
                _kill(procs)
                raise RuntimeError(f"rank {failed[0]} of {world} failed (exit code "
                                   f"{procs[failed[0]].exitcode}); every rank stopped")
            if deadline is not None and time.monotonic() > deadline:
                _kill(procs)
                raise TimeoutError(f"{world} ranks outlasted {time_limit} s; every rank killed")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"rank {failed[0]} of {world} failed (exit code "
                               f"{procs[failed[0]].exitcode})")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)


def _watch_parent() -> None:
    """A follower of ``lead``: end this process (exit code 1) once rank
    0's process is gone, since nothing else would end its wait for the next
    call."""
    parent = os.getppid()

    def poll():
        while True:
            time.sleep(PARENT_POLL_S)
            if os.getppid() != parent:
                print("mesh: rank 0's process is gone; stopping", file=sys.stderr, flush=True)
                os._exit(1)

    threading.Thread(target=poll, daemon=True).start()


def _follower_entry(rank, world, init_method, devices, backend, mesh_shape, threads, fn, args):
    _watch_parent()
    try:
        if threads:
            torch.set_num_threads(threads)
        start(rank, world, init_method, devices[rank], backend, FOLLOWER_TIMEOUT_S)
        fn(make_mesh(mesh_shape), *args)
        dist.barrier()   # with rank 0's shutdown: no message in flight at the teardown
        stop()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


def _watch(procs, done: threading.Event) -> None:
    """Rank 0 of ``lead``: a follower that dies (also before the group is
    up) ends this process too, with exit code 1, until ``done`` is set."""
    while not done.wait(0.2):
        for p in procs:
            if p.exitcode not in (None, 0):
                print(f"mesh: a follower rank exited with code {p.exitcode}; stopping",
                      file=sys.stderr, flush=True)
                os._exit(1)


def lead(devices: Sequence, follower: Callable, args: tuple = (),
         mesh_shape: Optional[dict] = None, threads: Optional[int] = None) -> Mesh:
    """This process becomes rank 0 of ``len(devices)`` ranks (on
    ``devices[0]``); ranks 1.. are spawned and run ``follower(mesh,
    *args)``, which builds the same objects as rank 0 (registering the
    same sharded functions in the same order) and calls ``mesh.follow()``.
    Returns rank 0's mesh; ``mesh.shutdown()`` ends the followers.  A
    follower that fails ends this process with exit code 1, and a follower
    ends itself when this process is gone."""
    world = len(devices)
    backend = pick_backend(devices)
    tmp = tempfile.mkdtemp(prefix="d2t_mesh_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    ctx = _mp()
    procs = [ctx.Process(target=_follower_entry,
                         args=(r, world, init_method, list(devices), backend, mesh_shape,
                               threads, follower, args), daemon=False)
             for r in range(1, world)]
    for p in procs:
        p.start()
    done = threading.Event()
    threading.Thread(target=_watch, args=(procs, done), daemon=True).start()
    try:
        start(0, world, init_method, devices[0], backend, FOLLOWER_TIMEOUT_S)
        mesh = make_mesh(mesh_shape)
    except BaseException:
        done.set()
        _kill(procs)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    mesh._followers, mesh._tmp, mesh._watching = procs, tmp, done
    return mesh
