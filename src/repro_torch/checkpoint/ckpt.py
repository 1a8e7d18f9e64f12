"""Checkpointing (port of ``repro.checkpoint.ckpt``) in ``repro``'s on-disk
format, so that each framework restores the other's files bit for bit.

Layout (one directory per step):
    step_00000420/
      manifest.json      step, meta, and per leaf: shape, dtype, bytes, crc
      <leafkey>.npy      one file per leaf of the state tree
      .complete          the commit marker

A state is a tree of dicts, NamedTuples (the optimizer's ``AdamWState``),
tuples and lists with tensors at the leaves. Leaves are named and ordered as
``repro`` names and orders them: the path parts joined by ``__`` (a dict
key, a NamedTuple field name, a sequence index), dict keys sorted. bf16 is
stored as its ``uint16`` bit view with the logical dtype ``"bfloat16"``
(never through f32); crc is the md5 of the first MiB of the stored bytes.
A checkpoint is written as ``step_XXXXXXXX.tmp``, renamed, then committed
by ``.complete``; restore ignores uncommitted directories, so a crash during
a write is harmless.

``AsyncCheckpointer`` copies the state to host memory on the calling thread
before ``save`` returns, and a background thread does the file I/O. The
copy is what makes it safe: the train step updates the state in place, so
the writer must never hold the caller's tensors.
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import re
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import DEFAULT_DEVICE

_ONE_CARD = ("restore places every leaf on one device; shardings come with "
             "the sharding slice (runtime/sharding.py): pass shardings=None")


def _map(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
         path: Tuple[str, ...] = ()) -> Any:
    """``tree`` rebuilt with ``fn(path, leaf)`` at each leaf, visiting the
    leaves in ``repro``'s order (dict keys sorted, then fields and items in
    order)."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        names = getattr(tree, "_fields", None)
        out = [_map(fn, v, path + (names[i] if names else str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if names else type(tree)(out)
    return fn(path, tree)


def _leaves(tree: Any) -> List[Tuple[Tuple[str, ...], Any]]:
    out: List[Tuple[Tuple[str, ...], Any]] = []
    _map(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def _leaf_key(path: Tuple[str, ...]) -> str:
    return "__".join(path) or "root"


def host_copy(state: Any) -> Any:
    """A copy of ``state`` in host memory, made now on the calling thread:
    later in-place updates of ``state`` do not reach it."""
    return _map(lambda _, t: t.detach().to("cpu", copy=True), state)


def _stored(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """→ (the array written to disk, its logical dtype)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(directory: str, step: int, state: Any,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous save of ``state`` (on any device, or a ``host_copy``),
    one leaf at a time. Returns the committed checkpoint path."""
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": step, "meta": meta or {}, "leaves": {}}
    for p, leaf in _leaves(state):
        key = _leaf_key(p)
        arr, logical_dtype = _stored(leaf)
        np.save(os.path.join(tmp, key + ".npy"), arr)
        manifest["leaves"][key] = {
            "shape": list(arr.shape),
            "dtype": logical_dtype,
            "bytes": int(arr.nbytes),
            "crc": _crc(arr),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    open(os.path.join(path, ".complete"), "w").close()
    return path


def _crc(arr: np.ndarray) -> str:
    head = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)[:1 << 20]
    return hashlib.md5(head.tobytes()).hexdigest()


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(directory, d, ".complete")):
            steps.append((int(m.group(1)), d))
    if not steps:
        return None
    return os.path.join(directory, max(steps)[1])


def restore_checkpoint(path: str, like: Any,
                       shardings: Optional[Any] = None,
                       verify: bool = True,
                       device: Optional[Any] = None) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, those of
    ``make_train_step``'s ``state_specs`` on ``meta`` included): each leaf
    checked against its crc and shape, cast to ``like``'s dtype (as
    ``repro`` casts) and placed on ``like``'s device, or on ``device``
    (default ``cuda``) where ``like`` is on ``meta``. → (state, manifest)."""
    if shardings is not None:
        raise NotImplementedError(_ONE_CARD)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves_meta = manifest["leaves"]
    fallback = torch.device(device if device is not None else DEFAULT_DEVICE)

    def load(p: Tuple[str, ...], leaf: torch.Tensor) -> torch.Tensor:
        key = _leaf_key(p)
        if key not in leaves_meta:
            raise KeyError(f"checkpoint {path} missing leaf {key}")
        arr = np.load(os.path.join(path, key + ".npy"))
        if verify and _crc(arr) != leaves_meta[key]["crc"]:
            raise IOError(f"checksum mismatch for {key} in {path}")
        if leaves_meta[key]["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        want_shape = tuple(leaf.shape)
        if tuple(t.shape) != want_shape:
            raise ValueError(
                f"{key}: checkpoint shape {tuple(t.shape)} != wanted {want_shape}")
        dev = fallback if leaf.device.type == "meta" else leaf.device
        return t.to(device=dev, dtype=leaf.dtype)

    return _map(load, like), manifest


def prune_checkpoints(directory: str, keep: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    done = sorted(d for d in os.listdir(directory)
                  if re.fullmatch(r"step_\d+", d)
                  and os.path.exists(os.path.join(directory, d, ".complete")))
    for d in done[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, d))


class AsyncCheckpointer:
    """Background-thread writer: snapshot on the caller, I/O off-thread."""

    def __init__(self, directory: str, keep: int = 3) -> None:
        self.directory = directory
        self.keep = keep
        self._q: "queue.Queue[Optional[Tuple[int, Any, Dict]]]" = queue.Queue()
        self._errors: List[BaseException] = []
        self._written: List[str] = []
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def save(self, step: int, state: Any,
             meta: Optional[Dict[str, Any]] = None) -> None:
        self._q.put((step, host_copy(state), meta or {}))   # sync copy

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_state, meta = item
            try:
                self._written.append(
                    save_checkpoint(self.directory, step, host_state, meta))
                prune_checkpoints(self.directory, self.keep)
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                self._errors.append(e)

    def wait(self) -> List[str]:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]
        return list(self._written)
