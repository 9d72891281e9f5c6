"""Fault-tolerant checkpoints (the JAX package's ``train/checkpoint.py``,
without ``msgpack``).

* One uncompressed ``arrays.npz`` per checkpoint, a leaf per entry under
  its path ("layers.wq"); numpy has no bfloat16, so a bf16 leaf is stored
  by its 16-bit patterns, and ``manifest.json`` records each leaf's
  dtype, shape and the SHA-1 of its bytes.
* Atomic: written into ``<dir>/tmp-<step>``, fsynced, renamed to
  ``<dir>/step-<step:08d>``; the ``latest`` pointer is written last.
* Integrity: ``restore_latest`` verifies every SHA-1 and walks back past
  a corrupt or partial checkpoint to the newest sound one.
* Retention: the newest ``keep`` checkpoints stay.
* On a mesh (``mesh=``, ``specs=``): rank 0 writes the global leaves,
  gathered leaf by leaf from the ranks that hold their blocks; a restore
  cuts each rank's block of every global leaf under ITS mesh and layout
  (elastic: a checkpoint saved on (2, 2) restores onto (1, 4), (4, 1),
  one device, or the serve layout of ``ModelPredictor(mesh=...)``).
  mamba2's ``conv_w`` and its optimizer leaves go by their
  ``ConvSpec``: gathered into JAX's global leaf, cut back by
  ``specs.cut`` into the port's layout.

Leaves are tensors (on any device) or numpy arrays; a restored leaf takes
the device of the matching leaf of ``like``, and the stored dtype.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import shutil
import zipfile

import numpy as np
import torch
import torch.distributed as dist

from .optimizer import cut_axes

def _named_leaves(tree, prefix=()):
    """(name, leaf) in sorted-key order; names join the path with '.'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], prefix + (str(k),))
    else:
        yield ".".join(prefix), tree


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array whose bytes are stored, dtype name)."""
    if not torch.is_tensor(leaf):
        arr = np.asarray(leaf)
        return arr, arr.dtype.name
    t = leaf.detach().cpu().contiguous()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), name
    return t.numpy(), name


def _from_numpy(arr: np.ndarray, dtype: str, shape, device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(shape)
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device)


def _flat_bytes(arr: np.ndarray) -> memoryview:
    """The array's bytes, C order, without a copy where it is
    contiguous."""
    return memoryview(np.ascontiguousarray(arr).reshape(-1)).cast("B")


def _sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(_flat_bytes(arr)).hexdigest()


def save_checkpoint(ckpt_dir, step: int, tree: dict, *,
                    keep: int = 3, mesh=None, specs=None) -> pathlib.Path:
    """Write ``tree`` as checkpoint ``step`` (atomic; the newest ``keep``
    stay). One leaf at a time: each is converted, hashed and streamed
    into ``arrays.npz``, so the host never holds the whole tree.

    On a ``mesh`` every rank calls this with its blocks, ``specs`` a
    tree like ``tree`` giving each cut leaf's spec (a leaf it lacks, or
    whose spec cuts nothing, is whole on every rank): rank 0 receives
    the blocks it lacks, leaf by leaf, and writes the GLOBAL leaves in
    the one-device format, so any mesh shape or layout can restore it;
    every rank returns once the write is complete (a barrier)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    final = ckpt_dir / f"step-{step:08d}"
    if mesh is not None and mesh.rank != 0:
        for name, leaf in _named_leaves(tree):
            if torch.is_tensor(leaf):
                _gather_leaf(leaf, _spec_of(specs, name), mesh)
        if mesh.size > 1:
            dist.barrier()                  # until rank 0 has written it
        return final
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp-{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "arrays": []}
    with zipfile.ZipFile(tmp / "arrays.npz", "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, leaf in _named_leaves(tree):
            if mesh is not None and torch.is_tensor(leaf):
                leaf = _gather_leaf(leaf, _spec_of(specs, name), mesh)
            arr, dtype = _to_numpy(leaf)
            manifest["arrays"].append({"name": name, "dtype": dtype,
                                       "shape": list(arr.shape),
                                       "sha1": _sha1(arr)})
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(_flat_bytes(arr))
            del arr, leaf
    with open(tmp / "arrays.npz", "rb+") as f:
        os.fsync(f.fileno())
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                          # atomic on POSIX
    (ckpt_dir / "latest.tmp").write_text(final.name)
    os.replace(ckpt_dir / "latest.tmp", ckpt_dir / "latest")
    _gc(ckpt_dir, keep)
    if mesh is not None and mesh.size > 1:
        dist.barrier()
    return final


def _spec_of(specs, name: str):
    """The spec of leaf ``name`` ("a.b.c") in the spec tree ``specs``;
    None where the tree has none."""
    node = specs
    for part in name.split("."):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _blocks(mesh, spec, shape) -> tuple:
    """([(rank, (start, length) per dim)], whole shape) for the ranks
    whose blocks make up a leaf of ``shape`` (this rank's block's shape)
    cut by ``spec``: the ranks at index 0 along every axis the leaf is
    whole on, one per block."""
    from repro_torch.launch.mesh import Mesh
    from repro_torch.sharding import specs as sh
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    whole = [n * mesh.degree(sh._axes_of(e)) for n, e in zip(shape, spec)]
    cut = set(a for e in spec for a in sh._axes_of(e))
    out = []
    for r in range(mesh.size):
        m = Mesh(mesh.devices_shape, mesh.axis_names, rank=r)
        if any(m.coords[a] for a in mesh.axis_names if a not in cut):
            continue
        out.append((r, [sh.block(m, e, n) for e, n in zip(spec, whole)]))
    return out, whole


def _wire(t):
    """``t`` where the world's backend sends it: the card for nccl, the
    host for gloo (whose point-to-point takes host tensors)."""
    if dist.get_backend() == "nccl":
        return t.contiguous()
    return t.detach().cpu().contiguous()


def _gather_leaf(leaf, spec, mesh):
    """On rank 0, the whole leaf (on the host) assembled from the blocks
    of the ranks that hold them (point to point, every block received at
    once); on the sending ranks, None; a leaf whole on every rank is rank
    0's own. A leaf in mamba2's conv layout (``specs.ConvSpec``) is its
    cut channels gathered, then its B and C channels (``whole_tail``,
    whole on every rank of the last dim's axes) as rank 0 holds them:
    JAX's global leaf, as ``specs.join_conv`` puts it together."""
    from repro_torch.sharding.specs import whole_tail
    tail = whole_tail(mesh, spec)
    if tail:
        head = _gather_leaf(leaf[..., :-tail], tuple(spec), mesh)
        bc = _gather_leaf(leaf[..., -tail:], tuple(spec[:-1]) + (None,),
                          mesh)
        return None if head is None else torch.cat([head, bc], dim=-1)
    if not cut_axes(mesh, spec):
        return leaf.detach().cpu() if mesh.rank == 0 else None
    blocks, whole = _blocks(mesh, spec, tuple(leaf.shape))
    if mesh.rank != 0:
        if any(r == mesh.rank for r, _ in blocks):
            dist.send(_wire(leaf.detach()), dst=0)
        return None
    parts = {r: _wire(torch.empty_like(leaf)) for r, _ in blocks
             if r != 0}
    waits = [dist.irecv(part, src=r) for r, part in parts.items()]
    out = torch.empty(whole, dtype=leaf.dtype)
    for w in waits:
        w.wait()
    for r, where in blocks:
        part = leaf.detach().cpu() if r == 0 else parts[r].cpu()
        view = out
        for dim, (start, n) in enumerate(where):
            view = view.narrow(dim, start, n)
        view.copy_(part)
    return out


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step-*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _members(path: pathlib.Path) -> dict:
    """{leaf name: (dtype, shape, byte offset)} of the arrays in
    ``arrays.npz``: each member is stored uncompressed, so its array is
    read in place (a memory map) instead of through ``zipfile``."""
    out = {}
    with open(path, "rb") as f, zipfile.ZipFile(f) as zf:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed")
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: {info.filename}: no local header")
            n_name = int.from_bytes(local[26:28], "little")
            n_extra = int.from_bytes(local[28:30], "little")
            f.seek(info.header_offset + 30 + n_name + n_extra)
            version = np.lib.format.read_magic(f)
            read = np.lib.format.read_array_header_1_0 if version == (1, 0) \
                else np.lib.format.read_array_header_2_0
            shape, fortran, dtype = read(f)
            if fortran:
                raise ValueError(f"{path}: {info.filename} is Fortran order")
            out[info.filename.removesuffix(".npy")] = (dtype, shape,
                                                       f.tell())
    return out


class CorruptCheckpoint(ValueError):
    """A checkpoint that cannot be read as it was written: a file that is
    missing or unreadable, a manifest or archive that does not parse, a
    leaf the archive lacks, or bytes that fail their SHA-1.
    ``restore_latest`` walks past these and nothing else: a sound
    checkpoint that does not fit the state it is restored into (a leaf
    missing from it, a block that does not cut) raises."""


@contextlib.contextmanager
def _reading(path):
    """Turns what reading ``path``'s files can raise into
    ``CorruptCheckpoint``."""
    try:
        yield
    except CorruptCheckpoint:
        raise
    except (OSError, EOFError, ValueError, KeyError, TypeError,
            zipfile.BadZipFile) as e:
        raise CorruptCheckpoint(f"{path}: {type(e).__name__}: {e}") from e


def _read_leaf(path: pathlib.Path, members: dict, ent: dict,
               verify: bool = True) -> np.ndarray:
    """Leaf ``ent`` of ``arrays.npz`` as a memory map (copy on write: the
    file is never written) in its stored shape, its SHA-1 checked when
    ``verify``; raises CorruptCheckpoint where it cannot be read so."""
    with _reading(path):
        dtype, shape, offset = members[ent["name"]]
        n = int(np.prod(shape))
        arr = np.zeros(shape, dtype) if n == 0 else np.memmap(
            path, dtype=dtype, mode="c", offset=offset, shape=(n,))
        if verify and _sha1(arr) != ent["sha1"]:
            raise CorruptCheckpoint(f"{path}: {ent['name']} fails its "
                                    f"SHA-1")
        return arr.reshape(ent["shape"])


def _splits_verification(mesh) -> bool:
    return mesh is not None and mesh.size > 1 and dist.is_initialized()


def load_checkpoint(path, like: dict, *, mesh=None, specs=None) -> dict:
    """The checkpoint at ``path`` in the structure of ``like`` (which may
    name a part of the stored tree): each leaf on the device of
    ``like``'s leaf, in the stored dtype and shape, every leaf's SHA-1
    checked as it is read. Raises CorruptCheckpoint where the files
    cannot be read as written, and KeyError where ``like`` has a leaf
    the checkpoint lacks. On a ``mesh``, each leaf that ``specs`` (a
    tree like ``like``) cuts is this rank's block of the stored global
    leaf (``sharding.specs.cut``): any mesh shape and layout restores
    any checkpoint. One leaf is on the host at a time, read in place
    from the file. On a mesh of a process group each rank checks the
    SHA-1 of every size-th leaf only and the outcome is shared (an
    ``all_reduce``): every rank returns, or raises, together, and a
    failure other than corruption on any rank is one everywhere."""
    from repro_torch.sharding import specs as sh
    path = pathlib.Path(path)
    split = _splits_verification(mesh)
    bad = None
    try:
        with _reading(path):
            manifest = json.loads((path / "manifest.json").read_text())
            ents = {e["name"]: e for e in manifest["arrays"]}
            members = _members(path / "arrays.npz")
        count = iter(range(len(ents)))

        def build(t, prefix=()):
            if isinstance(t, dict):
                return {k: build(t[k], prefix + (str(k),)) for k in t}
            name = ".".join(prefix)
            if name not in ents:
                raise KeyError(f"{path} has no leaf {name!r}: it was saved "
                               f"from a state of another structure")
            ent = ents[name]
            mine = next(count) % mesh.size == mesh.rank if split else True
            arr = _read_leaf(path / "arrays.npz", members, ent, mine)
            dev = t.device if torch.is_tensor(t) else "cpu"
            spec = _spec_of(specs, name) if mesh is not None else None
            if spec is None:
                return _from_numpy(arr, ent["dtype"], ent["shape"], dev)
            # the block alone leaves the map
            whole = _from_numpy_view(arr, ent["dtype"])
            block = sh.cut(whole, mesh, spec)
            return block.to(dev, copy=block is whole)
        tree = build(like)
    except Exception as e:  # noqa: BLE001 — shared with the other ranks
        if not split:
            raise
        tree, bad = None, e
    if split:
        # 1: corrupt here, 2: failed otherwise; the worst rank's verdict
        flag = torch.tensor([0 if bad is None else 1 if isinstance(
            bad, CorruptCheckpoint) else 2], device=mesh.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        worst = int(flag.item())
        if worst == 2:
            if bad is not None and not isinstance(bad, CorruptCheckpoint):
                raise bad
            raise RuntimeError(f"{path}: the restore failed on another "
                               f"rank")
        if worst == 1:
            raise CorruptCheckpoint(
                f"{path}: a leaf is unreadable or fails its SHA-1 on some "
                f"rank" + (f" (here: {bad})" if bad else ""))
    return tree


def _from_numpy_view(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A tensor over ``arr``'s memory (no copy; bf16 from its 16-bit
    patterns), to be cut and copied from."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_latest(ckpt_dir, like: dict, *, mesh=None, specs=None):
    """Walk checkpoints newest first (the ``latest`` pointer's first),
    skipping corrupt ones (``CorruptCheckpoint``). Returns (tree, step)
    or (None, -1); a sound checkpoint that does not fit ``like`` raises.
    On a ``mesh``: this rank's blocks, as ``load_checkpoint``; every
    rank reads the same files and so takes the same checkpoint."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None, -1
    candidates = sorted((p for p in ckpt_dir.glob("step-*") if p.is_dir()),
                        reverse=True)
    latest = ckpt_dir / "latest"
    if latest.exists():
        pointed = ckpt_dir / latest.read_text().strip()
        if pointed in candidates:
            candidates.remove(pointed)
            candidates.insert(0, pointed)
    for cand in candidates:
        try:
            tree = load_checkpoint(cand, like, mesh=mesh, specs=specs)
            with _reading(cand):
                step = json.loads(
                    (cand / "manifest.json").read_text())["step"]
        except CorruptCheckpoint:
            continue
        return tree, step
    return None, -1
