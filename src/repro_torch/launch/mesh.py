"""Device meshes over a ``torch.distributed`` process group.

The port's counterpart of the JAX package's ``launch/mesh.py``. A JAX
mesh names the axes of a grid of devices and lets ``shard_map`` bodies
run collectives by axis name; here every rank is one process (one card,
or the CPU), the grid is the world of a process group, and ``Mesh``
gives each rank:

  * the axis names and shape (``shape`` maps name -> size, as JAX's
    ``Mesh.shape``), this rank's coordinates, and one process group per
    axis: the ranks that differ from this one along that axis only;
  * the collectives the JAX package's sharded code uses, by axis:
    ``psum`` and ``pmax`` as an ``all_reduce`` (SUM, MAX), ``all_gather``
    (the list form, concatenated in axis-index order, as JAX's tiled
    ``all_gather``) and ``axis_index``.

Axes:
  pod   -- data-parallel only (pods);
  data  -- the batch;
  model -- tensor / expert parallel.

A collective over several axes runs one per axis, in the order given. A
collective over an axis of size 1 returns its input: no group exists for
it. Every rank ends a ``psum`` or ``pmax`` with the same bits (the
backend's ring reduces each element once, in an order fixed by the
world size and the tensor's size, and sends the result to every rank);
that is what lets every rank run the coder's host loop on the same
integers.

``run_ranks(fn, shape, axes, backend=...)`` starts one process per rank,
builds the world and its ``Mesh`` in each, runs ``fn(mesh, *args)`` and
returns rank 0's result. The caller names the backend: ``nccl`` where
each rank has its own card, ``gloo`` where ranks share one card or run
on the CPU (``device="cpu"``). Nothing switches backend or device when
one fails: ``nccl`` with more ranks than cards is refused before any
process starts, and a rank that raises ends the run with its traceback.
"""
from __future__ import annotations

import hashlib
import math
import os
import pathlib
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

#: the axes of the JAX package's meshes, outermost first
AXES = ("pod", "data", "model")


class Mesh:
    """This rank's view of a mesh of ``prod(shape)`` ranks: the world of
    the default process group (a world of one when none is initialized),
    laid out row-major over ``axes``. Every rank must construct its Mesh
    with the same shape and axes, at the same point: each axis's groups
    are created collectively.

    ``rank`` given (no process group): a layout-only mesh that stands for
    that rank of the grid, for computing its blocks in one process
    (``sharding.specs``); its collectives over an axis of more than one
    rank raise."""

    def __init__(self, shape, axes, *, device=None, rank=None):
        shape = tuple(int(s) for s in shape)
        axes = tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes) \
                or min(shape, default=1) < 1:
            raise ValueError(f"mesh shape {shape} and axes {axes} do not "
                             f"fit (one distinct name per dimension)")
        layout_only = rank is not None
        world = math.prod(shape) if layout_only else (
            dist.get_world_size() if dist.is_initialized() else 1)
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axes, shape))} needs "
                             f"{math.prod(shape)} ranks; the world has "
                             f"{world}")
        if layout_only and not 0 <= rank < world:
            raise ValueError(f"rank {rank} outside a mesh of {world}")
        self.axis_names = axes
        self.devices_shape = shape
        self.shape = dict(zip(axes, shape))
        self.size = world
        self.rank = int(rank) if layout_only else (
            dist.get_rank() if dist.is_initialized() else 0)
        self.coords = dict(zip(axes, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self.device = torch.device("cpu" if device is None else device)
        #: collectives run on this mesh (one per axis of more than one
        #: rank) and the bytes of their inputs: what a step costs in
        #: collectives (``chip_smoke.py`` phase 25)
        self.calls = 0
        self.bytes = 0
        #: a list to record every collective in, as (op, axis, shape,
        #: dtype, input bytes, output bytes), or None (``record``)
        self.log = None
        self._groups = {}
        if layout_only:
            self._groups = {a: None for a, n in self.shape.items() if n > 1}
            return
        grid = np.arange(world).reshape(shape)
        for i, a in enumerate(axes):
            if shape[i] == 1:
                continue
            # every rank creates every group of the axis, in one order
            for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
                ranks = [int(r) for r in line]
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[a] = g

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank} at {self.coords}, "
                f"{self.device})")

    # ------------------------------------------------------------ axes
    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_index(self, axis) -> int:
        """This rank's index along ``axis``, or along several axes taken
        together (outermost first, as JAX numbers a tuple of axes)."""
        idx = 0
        for a in _names(axis):
            idx = idx * self.axis_size(a) + self.coords.get(a, 0)
        return idx

    def degree(self, axis) -> int:
        """The number of ranks along ``axis`` (or a tuple of axes)."""
        return math.prod(self.axis_size(a) for a in _names(axis))

    # ----------------------------------------------------- collectives
    def _group(self, a: str):
        """The group of axis ``a``; None for an axis of one rank."""
        if a not in self._groups:
            return None
        g = self._groups[a]
        if g is None:
            raise RuntimeError(f"a layout-only mesh ({self.shape}, rank "
                               f"{self.rank}) runs no collectives")
        return g

    def _reduce(self, x: torch.Tensor, axis, op) -> torch.Tensor:
        for a in _names(axis):
            g = self._group(a)
            if g is None:
                continue
            x = x.contiguous()
            self._count(x, _OPS[op], a)
            dist.all_reduce(x, op=op, group=g)
        return x

    def _count(self, x: torch.Tensor, op: str, axis: str) -> None:
        n = x.numel() * x.element_size()
        self.calls += 1
        self.bytes += n
        self._record(op, axis, x, n)

    def _record(self, op: str, axis, x: torch.Tensor, n: int) -> None:
        if self.log is not None:
            out = n * self.degree(axis) if op in ("all_gather", "agree") \
                else n
            self.log.append((op, axis, tuple(x.shape), str(x.dtype), n,
                             out))

    def record(self) -> list:
        """Start recording this mesh's collectives (``log``) and return
        the list they go into: the dry run's log, and the real world's
        that a test holds it against."""
        self.log = []
        return self.log

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The sum of ``x`` over the ranks along ``axis``, on every one of
        them. Reduces in place when ``x`` is contiguous (pass a copy to
        keep it)."""
        return self._reduce(x, axis, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """The elementwise max of ``x`` over the ranks along ``axis``."""
        return self._reduce(x, axis, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0):
        """The ``x`` of every rank along ``axis``, concatenated on ``dim``
        in axis-index order (several axes: the innermost gathered first,
        so the blocks come outermost-major, as JAX's tiled gather)."""
        for a in reversed(_names(axis)):
            g = self._group(a)
            if g is None:
                continue
            x = x.contiguous()
            self._count(x, "all_gather", a)
            parts = [torch.empty_like(x) for _ in range(self.axis_size(a))]
            dist.all_gather(parts, x, group=g)
            x = torch.cat(parts, dim=dim)
        return x

    def agree(self, data: bytes) -> bool:
        """Whether every rank of the world passed the same bytes (their
        SHA-256 digests all-gathered): how a rank checks that its archive
        is rank 0's."""
        d = torch.tensor(list(hashlib.sha256(data).digest()),
                         dtype=torch.int32, device=self.device)
        if self.size == 1:
            return True
        self._record("agree", self.axis_names, d,
                     d.numel() * d.element_size())
        parts = [torch.empty_like(d) for _ in range(self.size)]
        dist.all_gather(parts, d)
        return all(torch.equal(p, parts[0]) for p in parts)


_OPS = {dist.ReduceOp.SUM: "psum", dist.ReduceOp.MAX: "pmax"}


class StandInMesh(Mesh):
    """A stand-in for rank ``rank`` of a mesh of ``shape``, in one
    process and without a process group (the dry run's: one process
    traces rank 0 of a 256- or 512-rank mesh). Its layout is the real
    mesh's (``Mesh(shape, axes, rank=...)``), and its collectives take
    tensors on the meta device: each returns what the real one would in
    shape and dtype, moves no data, and is counted and recorded as the
    real one is (``calls``, ``bytes``, ``log``: one entry per axis of
    more than one rank, in the real mesh's order). ``agree`` records one
    gather over the world and answers True."""

    def __init__(self, shape, axes, *, rank: int = 0, device="meta"):
        super().__init__(shape, axes, rank=rank, device=device)
        self.log = []

    def _reduce(self, x: torch.Tensor, axis, op) -> torch.Tensor:
        for a in _names(axis):
            if self.axis_size(a) > 1:
                self._count(x.contiguous(), _OPS[op], a)
        return x

    def all_gather(self, x: torch.Tensor, axis, dim: int = 0):
        for a in reversed(_names(axis)):
            n = self.axis_size(a)
            if n > 1:
                self._count(x, "all_gather", a)
                shape = list(x.shape)
                shape[dim] *= n
                x = x.new_empty(shape)
        return x

    def agree(self, data: bytes) -> bool:
        if self.size > 1:
            self._record("agree", self.axis_names,
                         torch.empty(32, dtype=torch.int32, device="meta"),
                         128)
        return True


def _names(axis) -> tuple:
    if axis is None:
        return ()
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def make_mesh(shape, axes=None, *, device=None) -> Mesh:
    """A mesh over the current world. ``shape`` may use -1 for one axis
    to take the remaining ranks; ``axes`` defaults to the last
    ``len(shape)`` of (pod, data, model)."""
    shape = tuple(int(s) for s in shape)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(n // known if s == -1 else s for s in shape)
    if axes is None:
        axes = AXES[-len(shape):] if len(shape) <= 3 \
            else tuple(f"ax{i}" for i in range(len(shape)))
    return Mesh(shape, axes, device=device)


def local_mesh(device=None) -> Mesh:
    """A one-rank (data 1, model 1) mesh."""
    return Mesh((1, 1), ("data", "model"), device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         stand_in_rank=None) -> Mesh:
    """The JAX package's production layout: (data 16, model 16), or
    (pod 2, data 16, model 16); the world must have that many ranks.
    ``stand_in_rank`` given: that rank's ``StandInMesh`` (no world; the
    dry run's)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = AXES if multi_pod else AXES[1:]
    if stand_in_rank is not None:
        return StandInMesh(shape, axes, rank=stand_in_rank)
    return Mesh(shape, axes, device=device)


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def mesh_degree(mesh, axis: str) -> int:
    return mesh.shape[axis] if axis in mesh.axis_names else 1


# ------------------------------------------------------------ the ranks
BACKENDS = ("nccl", "gloo")


def check_backend(backend: str, device: str, world: int) -> None:
    """Refuse a backend that cannot run ``world`` ranks on ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} (one of {BACKENDS})")
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r} (cuda or cpu)")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA cards; ranks on "
                             "the CPU take backend='gloo'")
        cards = torch.cuda.device_count()
        if cards < world:
            raise ValueError(
                f"backend 'nccl' needs one card per rank: {world} ranks, "
                f"{cards} card(s) (NCCL refuses two ranks on one device); "
                f"ranks that share a card run over backend='gloo'")
    elif dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: ranks run on the "
                           "card unless the caller passes device='cpu'")


def _fn_ref(fn) -> tuple:
    """(module, qualname, file) that a rank imports ``fn`` from; a
    function of a script run as ``__main__`` is loaded from its file."""
    mod = fn.__module__
    qual = fn.__qualname__
    if "<locals>" in qual or "<lambda>" in qual:
        raise ValueError(f"run_ranks needs a module-level function, got "
                         f"{mod}.{qual}")
    path = None
    if mod == "__main__":
        path = getattr(sys.modules["__main__"], "__file__", None)
        if path is None:
            raise ValueError("run_ranks: a function of an interactive "
                             "__main__ cannot be imported by the ranks")
        path = os.path.abspath(path)
    return mod, qual, path


def run_ranks(fn, shape, axes=None, *, backend: str, device: str = "cuda",
              args: tuple = (), kwargs: dict | None = None,
              store_dir=None, timeout: float = 1800.0):
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of a mesh of
    ``shape`` (axes as ``make_mesh``) and return rank 0's result.

    One process per rank (``python -m repro_torch.launch.rank_main``),
    each with one intra-op thread, joining a ``torch.distributed`` world
    over ``backend`` through a ``FileStore`` in a directory made under
    ``store_dir`` (the temporary directory if None) and removed at the
    end. Rank r runs on ``cuda:r`` with ``nccl``, on ``cuda:(r % cards)``
    with ``gloo`` on the card (ranks share it), or on the CPU. Every rank
    gets the caller's ``PYTHONHASHSEED`` (0 if unset). ``fn`` must be a
    module-level function the ranks can import (a script's own, run as
    ``__main__``, is loaded from its file); ``args``, ``kwargs`` and the
    result are pickled, tensors in the result moved to the CPU. A rank
    that fails ends the run: every other rank is killed and RuntimeError
    carries the tracebacks. So does ``timeout`` (seconds)."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        axes = AXES[-len(shape):]
    world = math.prod(shape)
    check_backend(backend, device, world)
    work = pathlib.Path(tempfile.mkdtemp(
        prefix="ranks-", dir=None if store_dir is None else str(store_dir)))
    job = dict(fn=_fn_ref(fn), args=tuple(args), kwargs=dict(kwargs or {}),
               shape=shape, axes=tuple(axes), backend=backend,
               device=str(device), world=world,
               store=str(work / "store"), timeout=float(timeout))
    (work / "job.pkl").write_bytes(pickle.dumps(job))
    child_env = dict(os.environ)
    # every rank hashes strings alike (set and dict orders, hash-seeded
    # data): the ranks run one program in lock-step
    child_env.setdefault("PYTHONHASHSEED", "0")
    child_env["PYTHONPATH"] = os.pathsep.join(
        p if p else os.getcwd() for p in sys.path)
    procs = []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.rank_main",
                 str(work), str(r)], env=child_env))
        t_end = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > t_end:
                break
            time.sleep(0.02)
        codes = [p.poll() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    try:
        if any(c != 0 for c in codes):
            errs = []
            for r, c in enumerate(codes):
                f = work / f"err{r}.txt"
                if f.exists():
                    errs.append(f"rank {r} (exit {c}):\n{f.read_text()}")
            why = "timed out" if any(c is None for c in codes) else "failed"
            raise RuntimeError(
                f"run_ranks {shape} over {backend} {why} (exit codes "
                f"{codes})" + ("\n" + "\n".join(errs) if errs else ""))
        return pickle.loads((work / "result.pkl").read_bytes())
    finally:
        shutil.rmtree(work, ignore_errors=True)
