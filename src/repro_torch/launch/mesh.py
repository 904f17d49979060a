"""Device meshes of the port: the reference's named-axis meshes over
``torch.distributed``.

The reference models a TPU v5e pod as a 16 x 16 chip mesh with axes
(data, model), and two pods as (2, 16, 16) with an outer ``pod`` axis.
Here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group (``nccl`` on the card, ``gloo`` for
``device="cpu"``), wrapped so that it exposes what the reference's
``jax.sharding.Mesh`` does: ``.shape`` (axis name -> size) and
``.axis_names``. The spec functions of ``sharding`` read only those two,
so they take this mesh, an ``AbstractMesh`` or any object with the same
attributes. A mesh runs the collectives the model code and the train
step call (``all_reduce`` with a sum or a max, ``all_gather``,
``reduce_scatter``), each over one axis or several, axes of size 1
skipped: ``Mesh`` over its process groups (and ``barrier``), ``DryMesh``
(the dry run's) by counting their bytes alone.

A mesh of one rank starts its own one-rank process group on an in-memory
``HashStore`` when none exists (no network) and destroys it on
``close()``. A mesh of more than one rank needs the caller's process
group (``torchrun``, or ``init_process_group`` with the address, world
size and rank): a production mesh asked for in a world of another size
raises, naming the ranks it needs. It never shrinks.
"""

from __future__ import annotations

import contextlib
import math
import os

import torch
import torch.distributed as dist

from .. import resolve_device

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group:
    the dry run's mesh (the reference's 512 placeholder devices), seen
    from rank 0 (every coordinate 0)."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.coords = dict.fromkeys(axes, 0)
        self.size = math.prod(shape)


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class DryMesh(AbstractMesh):
    """An ``AbstractMesh`` whose collectives compute nothing: each returns
    an empty result of its shape and adds its per-chip result bytes to
    ``collective_bytes`` by kind, the reference's convention
    (``dryrun.collective_bytes``: the gathered tensor of an all-gather,
    the reduced one of an all-reduce, the scattered shard of a
    reduce-scatter), once a call whatever the number of axes (one
    collective over their joint group, as XLA emits it). A call over axes
    of size 1 alone counts nothing, as ``Mesh`` runs nothing. The dry
    run's mesh."""

    KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...]):
        super().__init__(shape, axes)
        self.collective_bytes = dict.fromkeys(self.KINDS, 0)

    def _count(self, kind: str, out, axes):
        if math.prod(self.shape[a] for a in _axes(axes)) > 1:
            self.collective_bytes[kind] += out.numel() * out.element_size()
        return out

    def all_reduce(self, x, axes, op: str = "sum"):
        return self._count("all-reduce", x, axes)

    def all_gather(self, x, dim: int, axes):
        shape = list(x.shape)
        shape[dim] *= math.prod(self.shape[a] for a in _axes(axes))
        return self._count("all-gather", x.new_empty(shape), axes)

    def reduce_scatter(self, x, dim: int, axes):
        shape = list(x.shape)
        shape[dim] //= math.prod(self.shape[a] for a in _axes(axes))
        return self._count("reduce-scatter", x.new_empty(shape), axes)


class Mesh(AbstractMesh):
    """A ``DeviceMesh`` with the reference's axis names: ``.shape``,
    ``.axis_names``, this rank's ``.coords`` (axis -> index), each axis'
    process group (``group(axis)``) and the ``backend``. ``close()``
    destroys the process group where this mesh started it."""

    def __init__(self, device_mesh, device: torch.device, owns_group: bool):
        super().__init__(tuple(device_mesh.mesh.shape),
                         device_mesh.mesh_dim_names)
        self.device_mesh = device_mesh
        self.device = device
        self.coords = dict(zip(self.axis_names,
                               device_mesh.get_coordinate()))
        self.backend = dist.get_backend()
        self._owns_group = owns_group

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    _OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

    def all_reduce(self, x, axes, op: str = "sum"):
        """Reduce ``x`` in place over ``axes`` (an axis name or several),
        in x's dtype: ``op`` "sum" or "max"."""
        for axis in _axes(axes):
            if self.shape[axis] > 1:
                dist.all_reduce(x, op=self._OPS[op], group=self.group(axis))
        return x

    def all_gather(self, x, dim: int, axes):
        """Concatenate ``x`` along ``dim`` over ``axes``, the first named
        the major one (as a spec entry splits a dim)."""
        for axis in reversed(_axes(axes)):
            n = self.shape[axis]
            if n > 1:
                parts = [torch.empty_like(x) for _ in range(n)]
                dist.all_gather(parts, x.contiguous(),
                                group=self.group(axis))
                x = torch.cat(parts, dim=dim)
        return x

    def reduce_scatter(self, x, dim: int, axes):
        """Sum ``x`` over ``axes`` and keep this rank's slice of the sum
        along ``dim``: the slice ``all_gather`` over the same axes puts
        at this rank's place (the first axis the major one)."""
        for axis in _axes(axes):
            n = self.shape[axis]
            if n > 1:
                parts = [c.contiguous() for c in x.chunk(n, dim)]
                out = torch.empty_like(parts[0])
                dist.reduce_scatter(out, parts, group=self.group(axis))
                x = out
        return x

    def barrier(self) -> None:
        """Every rank of the mesh waits for the others (none at one)."""
        if self.size > 1:
            dist.barrier()

    def close(self) -> None:
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device="cuda") -> Mesh:
    """The counterpart of ``jax.make_mesh``: a ``DeviceMesh`` of ``shape``
    named ``axes`` over the default process group, on the card unless
    ``device`` says otherwise. The world must have exactly
    ``prod(shape)`` ranks."""
    dev = resolve_device(device)
    n = math.prod(shape)
    owns = False
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"the mesh {dict(zip(axes, shape))} needs a world of {n} "
                f"ranks, and no process group is running: launch under "
                f"torchrun --nproc-per-node {n} (or call "
                f"torch.distributed.init_process_group) first")
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(
            f"the mesh {dict(zip(axes, shape))} needs a world of {n} ranks; "
            f"this world has {world} (the port never shrinks a mesh)")
    if dev.type == "cuda":               # this rank's card, before the mesh
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh
    return Mesh(init_device_mesh(dev.type, tuple(shape),
                                 mesh_dim_names=tuple(axes)), dev, owns)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The reference's (16, 16) ("data", "model") pod, or (2, 16, 16)
    ("pod", "data", "model") with ``multi_pod``: 256 or 512 ranks."""
    return make_mesh(*PRODUCTION[multi_pod], device=device)


def production_abstract_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and names alone, for the dry run."""
    return AbstractMesh(*PRODUCTION[multi_pod])


def make_host_mesh(device="cuda") -> Mesh:
    """The degenerate (1, 1) mesh: the launch code on one device."""
    return make_mesh((1, 1), ("data", "model"), device=device)


def dp_axes(mesh) -> tuple[str, ...]:
    """Batch-sharding axes of a mesh, outermost first."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def tp_axis(mesh) -> str:
    return "model"


def dp_size(mesh) -> int:
    return math.prod(mesh.shape[a] for a in dp_axes(mesh))


@contextlib.contextmanager
def installed(mesh):
    """The mesh installed for the model code (``layers.set_shard_ctx``)
    for the duration of the block: its collectives run on ``mesh``
    (identities on axes of size 1)."""
    from ..models import layers as L
    dp = dp_axes(mesh)
    token = L.set_shard_ctx(dp if len(dp) > 1 else (dp[0] if dp else None),
                            tp_axis(mesh), dp_size(mesh),
                            mesh.shape[tp_axis(mesh)], mesh=mesh)
    try:
        yield mesh
    finally:
        L.reset_shard_ctx(token)
