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

Leaves travel one at a time: ``save`` writes each into the zip as it
comes and ``restore`` reads each key alone, so the host holds one whole
leaf at a time besides the tree itself. Under a mesh of more than one
rank (the manager's ``specs`` and ``mesh``) a tree holds this rank's
slices: ``save`` gathers each whole leaf in turn
(``launch.sharding.gather_leaf``, every rank taking part), rank 0
writes it into the same layout as one device does and the other ranks
drop it at once, then wait for rank 0 at a barrier; ``restore`` loads
the step rank 0 sees as the latest (the same on every rank) and keeps
each rank's slice of each leaf (``launch.sharding.local_slice``). So a
checkpoint written at one rank resumes under a mesh, and the reverse.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zipfile

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


def _host(arr: np.ndarray, dtype: str | None) -> torch.Tensor:
    """A loaded array as a host tensor of its saved dtype."""
    t = torch.from_numpy(np.require(arr, requirements="C"))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def _like(t: torch.Tensor, leaf):
    """A host tensor as ``leaf`` was: a tensor on its device in its
    dtype, else a numpy array (a bfloat16 one stays a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _path(key: str) -> tuple[str, ...]:
    """A saved key as a ``launch.sharding`` path (a field without its
    dot)."""
    return tuple(k[1:] if k.startswith(".") else k for k in key.split(_SEP))


def _rank0(mesh) -> bool:
    return not any(mesh.coords.values())


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, specs=None,
                 mesh=None):
        """``specs`` and ``mesh``: the sharding of the trees this manager
        saves and restores (a tree of ``launch.sharding`` specs matching
        them, and the mesh whose slices they hold); None, or a mesh of
        one rank, for whole trees."""
        self.dir = directory
        self.keep = keep
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.specs = specs
        if self.mesh is not None and specs is None:
            raise ValueError("a checkpoint of a sharded tree needs its specs")
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
        mesh = self.mesh
        if mesh is None:
            return self._write(step, _items(tree), extra, final)
        from ..launch import sharding as sh
        rank0 = _rank0(mesh)
        whole = ((key, sh.gather_leaf(leaf, sh.leaf_at(self.specs,
                                                       _path(key)),
                                      mesh, keep=rank0))
                 for key, leaf in _items(tree))
        if rank0:
            self._write(step, whole, extra, final)
        else:
            for _ in whole:            # every gather, each result dropped
                pass
        mesh.barrier()
        return final

    def _write(self, step: int, leaves, extra, final: str) -> str:
        """Write the (key, leaf) pairs of ``leaves`` as ``step``, each
        into ``arrays.npz`` as it comes (``np.savez``'s layout: one
        stored ``<key>.npy`` a leaf) and dropped before the next."""
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        keys, dtypes = [], {}
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED,
                                 allowZip64=True) as z:
                for key, leaf in leaves:
                    arr, dt = _to_numpy(leaf)
                    with z.open(key + ".npy", "w", force_zip64=True) as e:
                        np.lib.format.write_array(e, np.asanyarray(arr),
                                                  allow_pickle=False)
                    keys.append(key)
                    if dt is not None:
                        dtypes[key] = dt
                    del leaf, arr
            f.flush()
            os.fsync(f.fileno())
        meta = {"step": step, "keys": sorted(keys), "dtypes": dtypes,
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
        unless ``step`` is given): returns (tree, step). Under the
        manager's mesh ``tree_like`` holds this rank's slices, and each
        leaf comes back as this rank's slice of the saved one."""
        mesh = self.mesh
        if step is None:
            step = self.latest_step()
            if mesh is not None:             # rank 0's latest, everywhere
                mine = -1 if step is None or not _rank0(mesh) else step
                step = int(mesh.all_reduce(torch.tensor(
                    [mine], device=mesh.device), mesh.axis_names, op="max"))
                step = None if step < 0 else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            dtypes = json.load(f).get("dtypes", {})
        from ..launch import sharding as sh
        items = list(_items(tree_like))

        def load(z, key, leaf):
            t = _host(z[key], dtypes.get(key))
            if mesh is not None:
                part = sh.local_slice(t, sh.leaf_at(self.specs, _path(key)),
                                      mesh)
                if part is not t:        # keep the slice, drop the whole
                    t = part.clone()
            return _like(t, leaf)

        with np.load(os.path.join(path, "arrays.npz")) as z:
            missing = {k for k, _ in items} - set(z.files)
            if missing:
                raise KeyError(f"checkpoint {path} missing leaves: "
                               f"{sorted(missing)[:5]} ...")
            leaves = [load(z, k, leaf) for k, leaf in items]
        return _rebuild(tree_like, iter(leaves)), step

    def extra(self, step: int | None = None) -> dict:
        step = self.latest_step() if step is None else step
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)["extra"]
