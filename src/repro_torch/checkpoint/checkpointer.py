"""Fault-tolerant checkpointing, the port's counterpart of the reference's
``repro.checkpoint.checkpointer``, with its on-disk protocol:

* **atomic commit** — leaves stream into ``<dir>.tmp`` (one ``.npy`` a
  leaf), the manifest (leaf names, shapes, dtypes, step) is written last,
  then one rename publishes the checkpoint; a crashed writer can never
  produce a half-checkpoint that restore() would accept.
* **device-agnostic restore** — leaves are stored as host arrays; the
  restorer puts each on the device and in the dtype of the matching leaf
  of the target tree.
* **async writer** — a background thread drains a bounded queue, so the
  train loop is blocked only by the copy to the host, not the filesystem.
* retention of the newest K checkpoints; corrupted/partial dirs are
  ignored by ``latest_checkpoint``.

A tree is nested dicts, lists and tuples whose leaves are tensors: for
training, ``(model.state_dict(), opt_state)``.  A bf16 tensor (which
NumPy lacks) is stored as its raw 16-bit words and its dtype recorded.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

MANIFEST = "manifest.json"
_SAFE = re.compile(r"[^A-Za-z0-9_.-]")
#: dtypes stored as raw words, by their NumPy stand-in
_RAW = {torch.bfloat16: np.uint16}


class _HostLeaf:
    """A leaf already copied to the host: its array and dtype's name."""

    __slots__ = ("arr", "dtype")

    def __init__(self, leaf) -> None:
        self.arr, self.dtype = _host(leaf)


def _children(tree) -> Optional[list]:
    """(key, child) pairs of a node, or None for a leaf.  Dict keys are
    taken in sorted order, as ``jax.tree_util`` takes them."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    kids = _children(tree)
    if kids is None:
        return [(prefix or "leaf", tree)]
    out = []
    for k, child in kids:
        name = _SAFE.sub("_", str(k))
        out += _flatten(child, f"{prefix}/{name}" if prefix else name)
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    kids = _children(tree)
    if kids is None:
        return next(leaves)
    if isinstance(tree, dict):
        built = {k: _unflatten(child, leaves) for k, child in kids}
        return type(tree)((k, built[k]) for k in tree)
    return type(tree)(_unflatten(child, leaves) for _, child in kids)


def _structure(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ", ".join(f"{k!r}: {_structure(c)}" if isinstance(tree, dict)
                      else _structure(c) for k, c in kids)
    return ("{%s}" if isinstance(tree, dict) else "[%s]") % inner


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of ``leaf`` (never a view of it) and its dtype's name."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype in _RAW:
        return t.view(torch.int16).numpy().view(_RAW[t.dtype]), str(t.dtype)
    return t.numpy(), str(t.dtype)


def save_checkpoint(directory: str, step: int, tree: Any,
                    keep: int = 3) -> str:
    """Blocking atomic save. Returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    entries = []
    for i, (name, leaf) in enumerate(_flatten(tree)):
        arr, dtype = ((leaf.arr, leaf.dtype) if isinstance(leaf, _HostLeaf)
                      else _host(leaf))
        fname = f"{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        entries.append({"name": name, "file": fname,
                        "shape": list(arr.shape), "dtype": dtype})
    manifest = {"step": step, "entries": entries,
                "treedef": _structure(tree)}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _apply_retention(directory, keep)
    return final


def _apply_retention(directory: str, keep: int) -> None:
    ckpts = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.exists(os.path.join(directory, d, MANIFEST)))
    for stale in ckpts[:-keep]:
        shutil.rmtree(os.path.join(directory, stale))


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    best = None
    for d in sorted(os.listdir(directory)):
        p = os.path.join(directory, d)
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(p, MANIFEST)):
            best = p
    return best


def _restore_leaf(arr: np.ndarray, dtype: str, tgt: torch.Tensor):
    """``arr`` as a tensor on ``tgt``'s device and in its dtype."""
    if dtype == str(torch.bfloat16):
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=tgt.device, dtype=tgt.dtype)


def restore_checkpoint(path: str, target_tree: Any) -> tuple[int, Any]:
    """Restore into the structure of ``target_tree``, each leaf on the
    device and in the dtype of its target leaf.  Raises ``ValueError``
    when the leaf count or a shape differs."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves_meta = manifest["entries"]
    targets = [leaf for _, leaf in _flatten(target_tree)]
    if len(targets) != len(leaves_meta):
        raise ValueError(
            f"checkpoint has {len(leaves_meta)} leaves; target expects "
            f"{len(targets)}")
    out = []
    for meta, tgt in zip(leaves_meta, targets):
        arr = np.load(os.path.join(path, meta["file"]))
        if list(arr.shape) != list(tgt.shape):
            raise ValueError(
                f"shape mismatch for {meta['name']}: "
                f"{arr.shape} vs {tuple(tgt.shape)}")
        out.append(_restore_leaf(arr, meta["dtype"], tgt))
    return manifest["step"], _unflatten(target_tree, iter(out))


class AsyncCheckpointer:
    """Background-thread checkpoint writer with a bounded queue.  The
    caller's thread copies the tree to the host; the writer's thread
    writes it."""

    def __init__(self, directory: str, keep: int = 3, max_pending: int = 2):
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree = item
            try:
                save_checkpoint(self.directory, step, host_tree, self.keep)
            except BaseException as e:          # surfaced on next save/wait
                self._error = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any) -> None:
        if self._error:
            raise RuntimeError("async checkpoint failed") from self._error
        leaves = iter([_HostLeaf(leaf) for _, leaf in _flatten(tree)])
        self._q.put((step, _unflatten(tree, leaves)))

    def wait(self) -> None:
        self._q.join()
        if self._error:
            raise RuntimeError("async checkpoint failed") from self._error

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
