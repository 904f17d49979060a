"""Atomic checkpoint manager over trees of tensors.

Port of ``repro.checkpoint.manager``, with its layout: ``<dir>/step_<N>/``
holding ``arrays.npz`` (the flattened tree, one array per leaf under its
``/``-joined path, named as the reference names them: dict keys, tuple
indices, ``.field`` for a dataclass such as ``OptState``) and
``meta.json``, so either package restores what the other saved. Writes
go to ``step_<N>.tmp`` and are renamed into place only after fsync, so a
crash mid-save never corrupts the latest valid checkpoint; ``keep``
bounds disk usage. A tree
is nested dicts, lists, tuples and dataclasses (``OptState``) over
tensors (or numpy arrays and numbers). A leaf is saved bit for bit:
bfloat16, which numpy lacks, travels as its 16-bit pattern, its dtype in
the metadata. ``restore`` rebuilds the structure of a tree it is given,
each leaf on that leaf's device and in its dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import torch

_SEP = "/"


def _items(tree, prefix=""):
    """(path, leaf) pairs of ``tree`` in flatten order (dict keys
    sorted, as the reference's pytrees)."""
    if isinstance(tree, dict):
        kids = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        kids = [(str(i), t) for i, t in enumerate(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        # a field is ".name", as jax names a registered dataclass's field
        kids = [(f".{f.name}", getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    else:
        yield prefix, tree
        return
    for k, t in kids:
        yield from _items(t, f"{prefix}{_SEP}{k}" if prefix else k)


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from iterator ``it``."""
    if isinstance(tree, dict):
        out = {k: None for k in tree}
        for k in sorted(tree):
            out[k] = _rebuild(tree[k], it)
        return out
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(t, it) for t in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), it)
            for f in dataclasses.fields(tree)})
    return next(it)


def _to_numpy(leaf) -> tuple[np.ndarray, str | None]:
    """A leaf as a numpy array of the same bits, and "bfloat16" where
    numpy had to hold it as int16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), None
    return np.asarray(leaf), None


def _like(arr: np.ndarray, dtype: str | None, leaf):
    """A loaded array as ``leaf`` was: a tensor on its device in its
    dtype, else a numpy array."""
    t = torch.from_numpy(np.require(arr, requirements="C"))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    if isinstance(leaf, torch.Tensor):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return t.numpy() if dtype is None else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # -- discovery -----------------------------------------------------------

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ------------------------------------------------------------------

    def save(self, step: int, tree, *, extra: dict | None = None) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        arrays, dtypes = {}, {}
        for key, leaf in _items(tree):
            arrays[key], dt = _to_numpy(leaf)
            if dt is not None:
                dtypes[key] = dt
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": step, "keys": sorted(arrays), "dtypes": dtypes,
                "extra": extra or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
        # drop orphaned tmp dirs from crashed saves
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)

    # -- restore ---------------------------------------------------------------

    def restore(self, tree_like, *, step: int | None = None):
        """Restore into the structure of ``tree_like`` (the latest step
        unless ``step`` is given): returns (tree, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        items = list(_items(tree_like))
        missing = {k for k, _ in items} - set(arrays)
        if missing:
            raise KeyError(f"checkpoint {path} missing leaves: "
                           f"{sorted(missing)[:5]} ...")
        leaves = iter([_like(arrays[k], dtypes.get(k), leaf)
                       for k, leaf in items])
        return _rebuild(tree_like, leaves), step

    def extra(self, step: int | None = None) -> dict:
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)["extra"]
