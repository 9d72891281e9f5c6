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

Leaves are tensors (on any device) or numpy arrays; a restored leaf takes
the device of the matching leaf of ``like``, and the stored dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil

import numpy as np
import torch

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


def _sha1(arr: np.ndarray) -> str:
    return hashlib.sha1(np.ascontiguousarray(arr).tobytes()).hexdigest()


def save_checkpoint(ckpt_dir, step: int, tree: dict, *,
                    keep: int = 3) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp-{step}"
    final = ckpt_dir / f"step-{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "arrays": []}
    payload = {}
    for name, leaf in _named_leaves(tree):
        arr, dtype = _to_numpy(leaf)
        payload[name] = arr
        manifest["arrays"].append({"name": name, "dtype": dtype,
                                   "shape": list(arr.shape),
                                   "sha1": _sha1(arr)})
    with open(tmp / "arrays.npz", "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic on POSIX
    (ckpt_dir / "latest.tmp").write_text(final.name)
    os.replace(ckpt_dir / "latest.tmp", ckpt_dir / "latest")
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: pathlib.Path, keep: int) -> None:
    steps = sorted(p for p in ckpt_dir.glob("step-*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def _read(path: pathlib.Path):
    """(manifest, arrays by name), every SHA-1 checked; raises ValueError
    on a mismatch or a missing leaf."""
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "arrays.npz", allow_pickle=False) as z:
        arrays = {ent["name"]: z[ent["name"]] for ent in manifest["arrays"]}
    for ent in manifest["arrays"]:
        if _sha1(arrays[ent["name"]]) != ent["sha1"]:
            raise ValueError(f"{path}: {ent['name']} fails its SHA-1")
    return manifest, arrays


def _verify(path: pathlib.Path) -> bool:
    try:
        _read(path)
        return True
    except Exception:  # noqa: BLE001 — any corruption => invalid
        return False


def load_checkpoint(path, like: dict) -> dict:
    """The checkpoint at ``path`` in the structure of ``like``: each leaf
    on the device of ``like``'s leaf, in the stored dtype and shape."""
    path = pathlib.Path(path)
    manifest, arrays = _read(path)
    ents = {e["name"]: e for e in manifest["arrays"]}

    def build(t, prefix=()):
        if isinstance(t, dict):
            return {k: build(t[k], prefix + (str(k),)) for k in t}
        name = ".".join(prefix)
        ent = ents[name]
        dev = t.device if torch.is_tensor(t) else "cpu"
        return _from_numpy(arrays[name], ent["dtype"], ent["shape"], dev)
    return build(like)


def restore_latest(ckpt_dir, like: dict):
    """Walk checkpoints newest first (the ``latest`` pointer's first),
    skipping invalid or corrupt ones. Returns (tree, step) or
    (None, -1)."""
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
        if _verify(cand):
            step = json.loads((cand / "manifest.json").read_text())["step"]
            return load_checkpoint(cand, like), step
    return None, -1
