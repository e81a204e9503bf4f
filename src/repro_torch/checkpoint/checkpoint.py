"""Checkpoint / restore for fault tolerance (§4.3.5 backup-and-restore).

Port of ``repro.checkpoint.checkpoint``, with the same on-disk format: a
checkpoint written by either package restores in the other.

  * ``save(dir, step, tree, meta=...)`` — leaves to a .npz + a JSON manifest,
    written atomically (tmp + rename), so a crash mid-write never corrupts
    the latest-valid pointer; tensors are copied to the host;
  * ``latest_step`` / ``restore`` — resume from the newest *valid* manifest.
    Validity covers the array payload too (a manifest whose arrays.npz is
    missing or truncated is skipped);
  * ``restore`` validates every leaf's shape AND dtype against the target
    tree, fails loudly on missing arrays, and puts each array on the device
    of the matching target leaf;
  * old checkpoints are garbage-collected beyond ``keep``.

JAX's ``tree_flatten_with_path`` has no PyTorch counterpart, so this module
walks trees itself, in the order and with the path-entry kinds JAX uses for
the reference's state types: a dataclass gives ``a:<field>`` entries in
field order, skipping fields marked ``metadata={"static": True}`` (the
reference's static pytree metadata, e.g. a ``DiffusionGrid``'s spacing); a
dict gives ``k:<repr(key)>`` entries in sorted key order; a list or tuple
gives ``i:<n>`` (a namedtuple ``a:<field>``); ``None`` holds no leaf;
anything else (a tensor, a numpy array, a python scalar) is a leaf.  Keys are injective: every entry carries
its kind tag and separators are escaped, and ``save`` raises on a collision
rather than silently dropping a leaf.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"

# The dtypes a checkpoint carries, both ways, with no cast: the threefry key
# is uint32 (core/prng.py), which numpy and torch both hold as is.
_NP_OF_TORCH = {
    torch.bool: np.dtype(np.bool_),
    torch.uint8: np.dtype(np.uint8),
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.int32: np.dtype(np.int32),
    torch.int64: np.dtype(np.int64),
    torch.uint16: np.dtype(np.uint16),
    torch.uint32: np.dtype(np.uint32),
    torch.uint64: np.dtype(np.uint64),
    torch.float16: np.dtype(np.float16),
    torch.float32: np.dtype(np.float32),
    torch.float64: np.dtype(np.float64),
}


# ---------------------------------------------------------------------------
# Injective tree-path → array-key mapping
# ---------------------------------------------------------------------------


def _escape(s: str) -> str:
    """Escape the path separator (and the escape char itself) so joined keys
    remain injective for components containing "/"."""
    return s.replace("\\", "\\\\").replace("/", "\\s")


def _path_key(path) -> str:
    """One flat string per tree path, injective by construction.  A path is
    a sequence of ``(kind, value)`` entries: ``("k", key)`` dict key, by
    *repr* (``1`` and ``"1"`` stay distinct); ``("i", n)`` sequence index;
    ``("a", name)`` attribute; ``("x", n)`` flattened index."""
    parts = []
    for entry in path:
        kind, value = entry
        if kind == "k":
            parts.append("k:" + _escape(repr(value)))
        elif kind == "i":
            parts.append("i:" + str(value))
        elif kind == "a":
            parts.append("a:" + _escape(value))
        elif kind == "x":
            parts.append("x:" + str(value))
        else:  # unknown entry kind: repr, still tagged + escaped
            parts.append("r:" + _escape(repr(entry)))
    return "/".join(parts)


def _map_with_paths(tree, fn: Callable[[tuple, Any], Any], path: tuple = ()):
    """Rebuild ``tree`` with every leaf replaced by ``fn(path, leaf)``,
    visiting leaves in JAX's flattening order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_paths(tree[k], fn, path + (("k", k),))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # a namedtuple
        return type(tree)(*(_map_with_paths(getattr(tree, f), fn, path + (("a", f),))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_paths(v, fn, path + (("i", i),))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_with_paths(getattr(tree, f.name), fn, path + (("a", f.name),))
            for f in dataclasses.fields(tree)
            if f.init and not f.metadata.get("static", False)
        })
    return fn(path, tree)


def _leaves_with_paths(tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_with_paths(tree, lambda p, leaf: out.append((_path_key(p), leaf)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NP_OF_TORCH:
            raise TypeError(f"cannot checkpoint a {leaf.dtype} tensor")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree) -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, leaf in _leaves_with_paths(tree):
        if key in flat:
            raise ValueError(
                f"tree path key collision for {key!r} — two leaves map to "
                f"one checkpoint array; this is a bug in the key escaping"
            )
        flat[key] = _to_numpy(leaf)
    return flat


def n_leaves(tree) -> int:
    """The number of arrays ``save`` would write for ``tree``."""
    return len(_leaves_with_paths(tree))


# ---------------------------------------------------------------------------
# Save / GC / enumeration
# ---------------------------------------------------------------------------


def save(directory: str, step: int, tree: Any, keep: int = 3,
         meta: Optional[Dict[str, Any]] = None) -> str:
    """Atomically write checkpoint for ``step``; returns its path.

    ``meta`` is an optional JSON-serializable dict stored in the manifest
    (readable via :func:`read_manifest` without touching the arrays) — the
    model API records the run's target step and observable row counts there.
    """
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        flat = _flatten_with_paths(tree)
        np.savez(os.path.join(tmp, ARRAYS), **flat)
        manifest = {"step": step, "n_arrays": len(flat), "complete": True}
        if meta is not None:
            manifest["meta"] = meta
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(list_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"), ignore_errors=True)


def list_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and _valid(os.path.join(directory, name)):
            out.append(int(name[5:]))
    return sorted(out)


def _valid(path: str) -> bool:
    """A checkpoint directory is valid when its manifest parses as complete
    AND its array payload is intact (zip central directory readable, member
    count matching the manifest) — a truncated / corrupted arrays.npz makes
    the whole step invalid so resume falls back to the previous interval."""
    mf = os.path.join(path, MANIFEST)
    if not os.path.exists(mf):
        return False
    try:
        with open(mf) as f:
            manifest = json.load(f)
        if not manifest.get("complete"):
            return False
        with zipfile.ZipFile(os.path.join(path, ARRAYS)) as z:
            n = manifest.get("n_arrays")
            if n is not None and len(z.namelist()) != n:
                return False
    except (OSError, ValueError, AttributeError, zipfile.BadZipFile):
        return False
    return True


def latest_step(directory: str) -> Optional[int]:
    steps = list_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
    """Return ``(step, manifest)`` for ``step`` (default: latest valid)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no valid checkpoint under {directory}")
    with open(os.path.join(directory, f"step_{step:010d}", MANIFEST)) as f:
        return step, json.load(f)


# ---------------------------------------------------------------------------
# Restore (strict: shape + dtype + presence validated against the target)
# ---------------------------------------------------------------------------


def _leaf_signature(leaf) -> Tuple[tuple, np.dtype]:
    """(shape, numpy dtype) of a target leaf: a tensor, a numpy array or a
    python scalar."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype not in _NP_OF_TORCH:
            raise TypeError(f"cannot restore into a {leaf.dtype} tensor")
        return tuple(leaf.shape), _NP_OF_TORCH[leaf.dtype]
    arr = np.asarray(leaf)
    return tuple(arr.shape), arr.dtype


def restore(directory: str, like: Any, step: Optional[int] = None) -> Tuple[int, Any]:
    """Restore into the structure of ``like``.

    Every leaf of ``like`` must be present in the checkpoint with identical
    shape AND dtype; a missing or mismatched array raises with the offending
    key named.  Extra arrays in the checkpoint are ignored (``like`` may be a
    sub-structure of what was saved).  A tensor leaf of ``like`` comes back
    as a tensor on its device; any other leaf as a numpy array.
    """
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no valid checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:010d}", ARRAYS)

    def load(p, leaf):
        key = _path_key(p)
        if key not in data:
            raise ValueError(
                f"checkpoint step {step} under {directory} has no array for "
                f"{key!r} — structure mismatch (stale or foreign checkpoint)"
            )
        arr = data[key]
        want_shape, want_dtype = _leaf_signature(leaf)
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint has {arr.shape}, "
                f"target expects {want_shape}"
            )
        if np.dtype(arr.dtype) != want_dtype:
            raise ValueError(
                f"dtype mismatch for {key!r}: checkpoint has {arr.dtype}, "
                f"target expects {want_dtype}"
            )
        if isinstance(leaf, torch.Tensor):
            return torch.from_numpy(arr).to(leaf.device)
        return arr

    with np.load(path) as data:
        tree = _map_with_paths(like, load)
    return step, tree
