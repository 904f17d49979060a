"""The steps of the port (train, prefill, serve), and the dry run's cells.

``make_train_step`` is the reference's, differentiating the model's
``loss_fn`` with ``torch.autograd`` in place of ``jax.value_and_grad``:
the f32 master params are cast once a step (``convert.compute_view``)
and the gradients land in the f32 leaves; with ``microbatches`` > 1 the
batch rows are cut into that many slices whose gradients are summed in
f32 and averaged, as the reference's scan does. AdamW updates the params
and its state in place (the reference donates them). Under an installed
mesh of more than one rank the step is rank-local: this rank's slices of
the params and its rows of the batch, the model's tensor-parallel
collectives, FSDP gathers for the leaves split over the data axis, the
gradients averaged over the data-parallel ranks and clipped by the
norm of the whole tree (``make_train_step``).

``make_prefill_step`` / ``make_serve_step`` are the models' ``prefill``
(with the serving KV expansion) and ``decode_step`` under
``torch.no_grad``. ``abstract_cell(cfg, shape, mesh)`` builds a cell from
shapes alone, as the reference's ``jax.eval_shape`` does: params, state
and batch as ``meta`` tensors (bf16 for inference, f32 masters, AdamW's
state and labels for training), with their specs (``launch.sharding``;
a train cell's FSDP groups from the residency planner). ``lower_cell``
is the port's counterpart of lowering: it traces the cell's step on one
rank's local ``meta`` shards with a ``DryMesh`` installed (collectives
counted, not run), and returns what the dry run records (local argument
and output bytes, FLOPs, a peak of live tensor bytes, collective bytes
by kind). A train cell's trace runs the forward, the backward (each
remat block's forward again, its collectives with it) and AdamW. Every
family's cells run but the MoE family's train cells and those whose
split cuts a head, which raise.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from collections.abc import Callable
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import SHAPES, ModelConfig
from ..convert import compute_view, master_params
from ..kernels import meta
from ..models import get_model
from ..models import layers as L
from ..optim import OptState, adamw_init, adamw_update, cosine_schedule
from ..optim.adamw import leaves
from ..planner import plan_residency
from . import sharding as sh
from .mesh import DryMesh, dp_axes, installed


# --- abstract inputs -----------------------------------------------------------------

def batch_struct(cfg: ModelConfig, batch_size: int, seq_len: int, *,
                 labels: bool) -> dict[str, torch.Tensor]:
    """A cell's batch as ``meta`` tensors: tokens (and labels) (B, S)
    int32, whisper's frames and qwen2-vl's 1024 stub patch embeddings
    (B, n, D) f32."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")
    out = {"tokens": meta((batch_size, seq_len), torch.int32)}
    if labels:
        out["labels"] = meta((batch_size, seq_len), torch.int32)
    if cfg.family == "encdec":
        out["frames"] = meta((batch_size, cfg.encoder.seq_len, cfg.d_model),
                             torch.float32)
    if cfg.family == "vlm":
        out["patch_embeds"] = meta((batch_size, 1024, cfg.d_model),
                                   torch.float32)
    return out


@dataclasses.dataclass
class Cell:
    """Everything needed to lower one (arch x shape) combination: the
    step, its abstract (meta) arguments and their specs, the specs its
    outputs must have (the decode state's, and ``_logits_spec``)."""
    cfg: ModelConfig
    shape_name: str
    kind: str                       # train | prefill | decode
    step_fn: Callable
    args: tuple                     # meta tensors
    in_pspecs: tuple                # matching P trees
    out_pspecs: Any = None
    out_shapes: Any = None          # the outputs at one rank (meta)
    wide_tp: bool = False


def make_train_step(cfg, *, lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, remat: bool = True,
                    microbatches: int = 1, specs=None):
    """``train_step(params, opt, batch) -> (params, opt, metrics)``:
    params a tree of f32 master tensors, batch a dict of tensors on their
    device with a leading batch axis divisible by ``microbatches``;
    metrics {"loss", "grad_norm", "lr"} (0-d tensors on the device and a
    float).

    Under an installed mesh of more than one rank (``mesh.installed``)
    params, opt and batch are this rank's slices: the params by
    ``specs`` (``sharding.param_pspecs``, which the step needs there), the
    batch its rows (``sharding.batch_pspecs``), cut into its
    microbatches. The model calls its tensor-parallel collectives and
    gathers the leaves FSDP splits over the data axis where it uses
    them (``layers.fsdp_split``), their gradients reduce-scattered over
    data. Then the gradients are averaged over the data-parallel ranks
    (the others all-reduced over (pod, data), the FSDP ones over pod),
    the loss too, and AdamW clips by the norm of the whole tree and
    updates the local slices. At one rank (or a 1x1 mesh) every
    collective is the identity and the step is the one device's."""
    api = get_model(cfg)
    lr_fn = cosine_schedule(lr, warmup, total)

    def grads_of(params, flat, batch, fsdp):
        with L.fsdp_split(fsdp):
            loss = api.loss_fn(cfg, compute_view(params, fsdp), batch,
                               remat=remat)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    def train_step(params, opt: OptState, batch):
        mesh = L.shard_mesh()
        sharded = mesh is not None and mesh.size > 1
        if sharded and specs is None:
            raise ValueError(f"a train step under a mesh of {mesh.size} "
                             f"ranks needs the params' specs")
        fsdp = {"/".join(path): d for path, spec in sh.flatten(specs)
                if (d := sh.fsdp_dim(spec)) is not None} if sharded else {}
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(params, flat, batch, fsdp)
        else:
            parts = {k: v.chunk(microbatches) for k, v in batch.items()}
            if any(len(v) != microbatches or v[0].shape[0] * microbatches
                   != batch[k].shape[0] for k, v in parts.items()):
                raise ValueError(f"batch rows must divide into "
                                 f"{microbatches} microbatches")
            loss, grads = 0.0, None
            for i in range(microbatches):
                li, gi = grads_of(params, flat,
                                  {k: v[i] for k, v in parts.items()},
                                  fsdp)
                loss = loss + li
                if grads is None:
                    grads = [g.float() for g in gi]
                else:
                    torch._foreach_add_(grads, gi)
            torch._foreach_div_(grads, float(microbatches))
            loss = loss / microbatches
        kw = {}
        if sharded:
            spec_list = leaves(specs)
            loss = _average_over_data(mesh, grads, loss, spec_list)
            kw = dict(replication=[sh.replication(s, mesh)
                                   for s in spec_list], mesh=mesh)
        params, opt, metrics = adamw_update(params, grads, opt, lr_fn=lr_fn,
                                            **kw)
        metrics["loss"] = loss
        return params, opt, metrics

    return train_step


def _average_over_data(mesh, grads, loss, spec_list):
    """Average this rank's gradients (in place) and its loss over the
    data-parallel ranks: a sum over (pod, data), or over pod alone for a
    leaf FSDP splits over data (its backward summed over data already),
    then a division by their number. Every rank holds an equal share of
    the global batch's rows and each microbatch's loss is a mean over its
    rows, so for the dense family the averaged loss and gradients are the
    reference's mean over the global batch, whichever rows form a
    microbatch (MoE's load-balance statistic, taken per microbatch, will
    not be)."""
    dp = dp_axes(mesh)
    n = math.prod(mesh.shape[a] for a in dp)
    for g, spec in zip(grads, spec_list):
        if g.numel():                   # olmo's norms are empty leaves
            fsdp = sh.fsdp_dim(spec) is not None
            mesh.all_reduce(g, tuple(a for a in dp
                                     if not (fsdp and a == "data")))
    loss = mesh.all_reduce(torch.as_tensor(loss).clone(), dp)
    if n > 1:
        torch._foreach_div_(grads, float(n))
        loss = loss / n
    return loss


def make_prefill_step(cfg: ModelConfig, cache_len: int, kv_expand: int = 1):
    api = get_model(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch, cache_len,
                           kv_expand=kv_expand)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    api = get_model(cfg)

    @torch.no_grad()
    def serve_step(params, state, tokens):
        return api.decode_step(cfg, params, state, tokens)

    return serve_step


# --- cell assembly -------------------------------------------------------------------

def _logits_spec(shape, mesh, *, wide_tp: bool = False) -> sh.P:
    """(B, ..., V): batch over the data axes, vocabulary over model, as
    the head's column split produces them (gathering V would cost a full
    head all-gather a step); under wide TP V takes both axes and the
    batch is replicated."""
    tp_total = mesh.shape["model"] * (mesh.shape.get("data", 1)
                                      if wide_tp else 1)
    dims = [None] * len(shape)
    if wide_tp and shape[-1] % tp_total == 0:
        dims[-1] = ("model", "data")
    else:
        dims[0] = sh.batch_dim_spec(shape[0], mesh)
        if shape[-1] % mesh.shape["model"] == 0:
            dims[-1] = "model"
    return sh.P(*dims)


def default_microbatches(cfg: ModelConfig, shape, mesh) -> int:
    """Enough accumulation to fit activations; more for bigger models."""
    dp = 1
    for a in ("pod", "data"):
        dp *= mesh.shape.get(a, 1)
    limit = max(1, shape.global_batch // max(1, dp))   # >=1 row per shard
    want = 8 if (cfg.moe or cfg.param_count() > 3e10) else 4
    return min(want, limit)


def _bf16(tree):
    """Serving checkpoints are bf16: every floating leaf as bf16."""
    return sh.tree_map(lambda _, t: t.to(torch.bfloat16)
                       if t.is_floating_point() else t, tree)


def abstract_cell(cfg: ModelConfig, shape_name: str, mesh, *,
                  train_fsdp: bool = True,
                  microbatches: int | None = None) -> Cell:
    """The cell of ``cfg`` at ``SHAPES[shape_name]`` on ``mesh``, from
    shapes alone (``meta`` tensors). Decode cells of models whose bf16
    weights exceed 0.35 x 16 GiB a rank at 16-way TP take wide TP, as in
    the reference; prefill keeps classic TP."""
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return _train_cell(cfg, shape_name, mesh, train_fsdp, microbatches)
    api = get_model(cfg)
    params_s = _bf16(api.init_params(cfg, device="meta"))
    param_gb = 2 * cfg.param_count() / mesh.shape["model"] / 2**30
    wide_tp = shape.kind == "decode" and param_gb > 0.35 * 16.0
    p_spec = sh.param_pspecs(params_s, mesh, wide_tp=wide_tp)
    kv_e = L.serve_kv_expand(cfg, mesh.shape["model"])
    B = shape.global_batch

    if shape.kind == "prefill":
        batch_s = batch_struct(cfg, B, shape.seq_len, labels=False)
        step = make_prefill_step(cfg, shape.seq_len, kv_expand=kv_e)
        out = step(params_s, batch_s)                # one rank, no mesh
        return Cell(cfg, shape_name, "prefill", step, (params_s, batch_s),
                    (p_spec, sh.batch_pspecs(batch_s, mesh)),
                    (_logits_spec(out[0].shape, mesh),
                     sh.state_pspecs(out[1], mesh)), out)

    # decode: one token against a seq_len cache, written at its last row
    # (a state's position, where it has one), so that a step that attends
    # its cache's prefix alone (MLA's) attends the whole of it
    state_s = api.init_decode_state(cfg, B, shape.seq_len, kv_expand=kv_e,
                                    device="meta")
    if hasattr(state_s, "pos"):
        state_s = dataclasses.replace(state_s, pos=shape.seq_len - 1)
    tok_s = torch.empty((B,), dtype=torch.int32, device="meta")
    step = make_serve_step(cfg)
    out = step(params_s, dataclasses.replace(state_s), tok_s)
    return Cell(cfg, shape_name, "decode", step, (params_s, state_s, tok_s),
                (p_spec, sh.state_pspecs(state_s, mesh),
                 sh.P(sh.batch_dim_spec(B, mesh))),
                (_logits_spec(out[0].shape, mesh, wide_tp=wide_tp),
                 sh.state_pspecs(out[1], mesh)), out, wide_tp=wide_tp)


def _train_cell(cfg, shape_name, mesh, train_fsdp, microbatches) -> Cell:
    """The reference's train branch: f32 master params with FSDP over the
    data axis for the residency planner's streamed groups
    (``plan_residency(train=True)``; none without ``train_fsdp``),
    AdamW's state sharded as the params (its step count on the host,
    where ``adamw_update`` reads it), the batch with labels over the data
    axes, ``default_microbatches``. The step's outputs keep the inputs'
    specs (the reference lets XLA propagate them so)."""
    shape = SHAPES[shape_name]
    api = get_model(cfg)
    params_s = master_params(api.init_params(cfg, device="meta"))
    plan = plan_residency(cfg, tp=mesh.shape["model"],
                          dp=mesh.shape.get("data", 1), train=True)
    streamed = plan.streamed if train_fsdp else frozenset()
    p_spec = sh.param_pspecs(params_s, mesh, streamed_groups=streamed)
    opt_s = adamw_init(params_s)
    o_spec = sh.opt_pspecs(p_spec, mesh)
    batch_s = batch_struct(cfg, shape.global_batch, shape.seq_len,
                           labels=True)
    b_spec = sh.batch_pspecs(batch_s, mesh)
    if microbatches is None:
        microbatches = default_microbatches(cfg, shape, mesh)
    step = make_train_step(cfg, microbatches=microbatches, specs=p_spec)
    scalar = torch.empty((), device="meta")
    return Cell(cfg, shape_name, "train", step, (params_s, opt_s, batch_s),
                (p_spec, o_spec, b_spec),
                (p_spec, o_spec, {"grad_norm": sh.P(), "loss": sh.P()}),
                (params_s, opt_s, {"grad_norm": scalar, "loss": scalar}))


# --- lowering -------------------------------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """The bytes of the tensors an op sequence allocates and still holds,
    and their peak: each storage counted once, from the op that made it
    to the death of its last tensor. Storages of ``known`` tensors (the
    arguments) are not counted. The port's own measure of a step's
    temporary memory, not XLA's ``memory_analysis``."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._refs: dict[int, list] = {}
        self._known = {t.untyped_storage()._cdata for t in known}

    def _drop(self, key: int) -> None:
        entry = self._refs.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            key = t.untyped_storage()._cdata
            if key in self._known:
                continue
            entry = self._refs.get(key)
            if entry is None:
                entry = self._refs[key] = [t.untyped_storage().nbytes(), 0]
                self.live += entry[0]
                self.peak = max(self.peak, self.live)
            entry[1] += 1
            weakref.finalize(t, self._drop, key)
        return out


@dataclasses.dataclass
class Lowered:
    """One rank's trace of a cell (``lower_cell``)."""
    args: tuple                     # this rank's meta shards
    out: Any                        # the step's outputs, local
    flops: int                      # FlopCounterMode's, the kernels' in
    kernel_flops: int               # the kernels' (``kernels.meta``)
    peak_live_bytes: int            # LiveBytes over the step
    collective_bytes: dict[str, int]


def _tensors(tree) -> list:
    return [t for _, t in sh.flatten(tree) if isinstance(t, torch.Tensor)]


def lower_cell(cell: Cell, mesh) -> Lowered:
    """Trace the cell's step on one rank's local ``meta`` shards (rank 0
    of ``mesh``'s shape), with a ``DryMesh`` of that shape installed; the
    outputs must have the local shapes of the cell's output specs."""
    if cell.wide_tp:
        tp = mesh.shape["model"] * mesh.shape.get("data", 1)
        raise NotImplementedError(
            f"{cell.cfg.name} {cell.shape_name}: wide TP ({cell.cfg.num_heads}"
            f" heads over {tp} model x data ranks"
            + (", which cuts a head" if cell.cfg.num_heads % tp else "")
            + ") waits for a later slice of the mesh port")

    def local(tree, specs):
        return sh.tree_map(lambda path, t: torch.empty(
            sh.local_shape(t.shape, sh.leaf_at(specs, path), mesh),
            dtype=t.dtype, device="meta")
            if isinstance(t, torch.Tensor) and t.is_meta else t, tree)

    args = tuple(local(a, s) for a, s in zip(cell.args, cell.in_pspecs))
    dry = DryMesh(tuple(mesh.shape.values()), mesh.axis_names)
    with installed(dry):
        if cell.kind == "train":
            L.single_rank_family(cell.cfg)
        with FlopCounterMode(display=False) as fc, \
                LiveBytes(_tensors(args)) as live:
            out = cell.step_fn(*args)
    for path, t in sh.flatten(out):
        if isinstance(t, torch.Tensor) and t.is_meta:
            want = sh.local_shape(sh.leaf_at(cell.out_shapes, path).shape,
                                  sh.leaf_at(cell.out_pspecs, path), mesh)
            assert tuple(t.shape) == want, (path, tuple(t.shape), want)
    counts = fc.get_flop_counts()["Global"]
    kernels = sum(counts.get(op, 0) for op in meta.OPS)
    return Lowered(args, out, int(fc.get_total_flops()), int(kernels),
                   live.peak, dry.collective_bytes)
