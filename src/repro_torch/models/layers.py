"""Model building blocks of the port (``repro.models.layers`` without
the one-hot MoE oracle ``moe_router`` / ``moe_ffn_dense``: dense, vlm,
MoE, ssm and encoder-decoder serving, training: the loss, the MoE
load-balance loss, remat; and the shard context with the collectives
that tensor-parallel serving and training call, the vocabulary-parallel
loss among them, and the MoE dispatch's data-parallel groups and expert
parallelism), in PyTorch.

Conventions kept from the reference: compute in bf16, norms and biases
in f32 at use, logits in f32; shapes polymorphic over batch and sequence.
The paged-cache writers update the pool in place (the reference donates
it); nothing on a training forward writes in place.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from .. import resolve_device
from ..kernels import ops

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32
NEG_INF = -1e30


# --- the shard context ------------------------------------------------------------
# The reference installs its mesh's axis names at trace time and lets XLA's
# SPMD partitioner insert the collectives. The port runs rank-locally: the
# launcher installs the mesh here, and the model code calls the
# collectives below where the partitioner would have put them. Each is an
# identity on an axis of size 1, and with no context installed, so one
# device (and the 1x1 host mesh) runs exactly the code it ran before,
# CUDA graphs included; on a larger axis it is the installed mesh's
# (``launch.mesh``: a process group's, or a dry mesh's that only counts).

_SHARD_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_shard_ctx", default=None)


def set_shard_ctx(dp_axes, tp_axis: str | None, dp_size: int = 1,
                  tp_size: int = 1, *, mesh=None):
    """Install a mesh for the model code; returns a token for
    ``reset_shard_ctx``. ``mesh`` (a ``launch.mesh`` mesh) gives this
    rank's coordinates and runs the collectives."""
    return _SHARD_CTX.set({"dp": dp_axes, "tp": tp_axis,
                           "dp_size": dp_size, "tp_size": tp_size,
                           "mesh": mesh})


def reset_shard_ctx(token):
    _SHARD_CTX.reset(token)


def dp_group_count() -> int:
    """Number of data-parallel groups for group-local MoE dispatch."""
    ctx = _SHARD_CTX.get()
    return int(ctx.get("dp_size", 1)) if ctx else 1


def tp_size() -> int:
    """Ranks on the tensor-parallel (model) axis; 1 without a mesh."""
    ctx = _SHARD_CTX.get()
    return int(ctx["tp_size"]) if ctx else 1


def tp_rank() -> int:
    """This rank's index on the model axis (0 in a dry run)."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx["mesh"] is None:
        return 0
    return int(ctx["mesh"].coords.get(ctx["tp"], 0))


def single_rank_family(cfg) -> None:
    """Every family but MoE trains sharded; the MoE family serves sharded
    (expert-parallel experts, head-parallel MLA) but trains on one rank:
    a MoE training step under a mesh of more than one rank raises (its
    gradients through the expert-parallel all-reduce and the
    load-balance loss under groups come with a later slice)."""
    ctx = _SHARD_CTX.get()
    if ctx and ctx["tp_size"] * ctx["dp_size"] > 1 and cfg.family == "moe":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family trains on one rank only; "
            f"its sharded training comes with a later slice of the mesh "
            f"port (ROADMAP, Queue 1, item 2.1, the training half)")


def global_tokens(n: int) -> int:
    """The tokens of the whole batch of which this rank holds ``n``: n
    times the data-parallel ranks under an installed mesh (each holds its
    rows of the batch, split over the data axes), n without one."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx["mesh"] is None:
        return n
    return n * int(ctx["dp_size"])


def dp_rank() -> int:
    """This rank's index over the data-parallel axes, the outermost
    major (the order ``dp_all_gather`` concatenates in); 0 without a
    mesh and in a dry run."""
    mesh = shard_mesh()
    if mesh is None:
        return 0
    idx = 0
    for a in mesh.axis_names:
        if a in ("pod", "data"):
            idx = idx * mesh.shape[a] + mesh.coords.get(a, 0)
    return idx


def _cuts_a_head(cfg, detail: str):
    raise NotImplementedError(
        f"{cfg.name}: {tp_size()}-way tensor parallelism cuts a head "
        f"({detail}); such cells wait for a later slice of the mesh port")


def whole_heads(cfg, cols: int, what: str, dh: int | None = None) -> int:
    """The heads of head dim ``dh`` (``cfg.head_dim``) in ``cols`` columns
    of a rank's slice of ``what``; raises where the model axis' split
    cuts a head."""
    dh = dh or cfg.head_dim
    if cols % dh:
        _cuts_a_head(cfg, f"{what} {cols} columns a rank, dh {dh}")
    return cols // dh


def rank_heads(cfg, q_cols: int, e: int) -> tuple[int, int]:
    """This rank's (q heads, cache heads) from the ``q_cols`` columns of
    its wq slice and the KV expansion ``e``; raises where the split cuts
    a head or leaves the rank's q heads without their whole KV heads."""
    tp = tp_size()
    hl, kve = whole_heads(cfg, q_cols, "wq"), cfg.num_kv_heads * e
    if kve % tp:
        _cuts_a_head(cfg, f"{kve} cache heads")
    if tp > 1 and q_cols * tp != cfg.q_dim:
        raise NotImplementedError(
            f"{cfg.name}: wq is not split over the {tp} model ranks; the "
            f"rank-local executor runs split heads only")
    ce = kve // tp
    if hl % ce:
        raise NotImplementedError(
            f"{cfg.name}: {hl} q heads a rank do not group over {ce} "
            f"cache heads")
    return hl, ce


def cache_heads(cfg, t, e: int, ce: int):
    """(B, S, columns) from this rank's wk or wv slice -> the rank's
    ``ce`` cache heads (B, S, ce, dh): its own heads where the slice holds
    whole heads and nothing is expanded, else the whole KV projection
    (gathered over the model axis where the slice cuts a head), expanded
    e times and cut to the rank's heads."""
    B, S, cols = t.shape
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    if e == 1 and cols == ce * dh:
        return t.view(B, S, ce, dh)
    if cols != kv * dh:
        t = gather_from_tp(t, -1)
    full = expand_kv(t.view(B, S, kv, dh), e)
    if full.shape[2] == ce:
        return full
    r = tp_rank()
    return full[:, :, r * ce:(r + 1) * ce].contiguous()


def kv_expansion(cfg, heads: int) -> int:
    """The KV expansion of a cache (or page pool) holding ``heads`` heads
    on each of the model axis' ranks."""
    return heads * tp_size() // cfg.num_kv_heads


def cache_head_count(cfg, e: int) -> int:
    """The cache heads a rank holds with each KV head stored ``e``
    times."""
    return cfg.num_kv_heads * e // tp_size()


def serve_kv_expand(cfg, tp: int) -> int:
    """KV-head replication factor for serving under tensor parallelism.

    Storing each KV head e times makes the cache head axis divide the
    model axis, aligning every rank's q heads with exactly its resident
    KV heads. Returns 1 when expansion can't align (then the reference's
    cache shards over dh instead, which cuts a head)."""
    kv, h = cfg.num_kv_heads, cfg.num_heads
    if cfg.mla is not None or kv == 0:
        return 1
    e = tp // math.gcd(kv, tp)
    if e > 1 and (kv * e) % tp == 0 and h % (kv * e) == 0 and e <= tp:
        return e
    return 1


def expand_kv(k, e: int):
    """(B, S, KV, dh) -> (B, S, KV*e, dh); q head h maps to expanded head
    h // (G/e), preserving grouping (each head repeated in place)."""
    return k if e == 1 else torch.repeat_interleave(k, e, dim=2)


def tp_all_reduce(x):
    """Sum ``x`` over the model axis, in x's dtype and in place (the
    reference's partitioner sums a row-parallel product's partial sums
    so). The result is the same on every rank. Serving's collective:
    training's forward takes ``reduce_from_tp``."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx["tp_size"] == 1:
        return x
    return ctx["mesh"].all_reduce(x, ctx["tp"])


def tp_all_gather(x, dim: int = -1):
    """Concatenate every model rank's ``x`` along ``dim``, in rank order."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx["tp_size"] == 1:
        return x
    return ctx["mesh"].all_gather(x, dim, (ctx["tp"],))


def dp_all_gather(x, dim: int = 0):
    """Concatenate every data-parallel rank's ``x`` along ``dim``, the
    outermost axis (pod) major, as the batch specs split it; ``x``
    itself without a mesh, whose process holds every row."""
    ctx = _SHARD_CTX.get()
    if ctx is None or ctx["dp_size"] == 1 or ctx["mesh"] is None:
        return x
    mesh = ctx["mesh"]
    return mesh.all_gather(x, dim, tuple(a for a in mesh.axis_names
                                         if a in ("pod", "data")))


def shard_mesh():
    """The installed mesh, or None."""
    ctx = _SHARD_CTX.get()
    return None if ctx is None else ctx["mesh"]


# --- differentiable collectives ----------------------------------------------------
# Megatron's pair and the gather, for the training forward under tensor
# parallelism. A replicated activation enters a column-parallel product
# through ``copy_to_tp`` (its gradient, partial on each rank, is summed in
# the backward); a row-parallel product's partial sums leave through
# ``reduce_from_tp`` (summed in the forward, the replicated gradient
# passed to each rank's part); ``gather_from_tp`` concatenates the model
# ranks' slices of a tensor each rank then uses in part (its gradient,
# partial on each rank, is summed and cut back to the rank's slice: a
# reduce-scatter); ``gather_whole`` concatenates the slices of a tensor
# every rank then uses whole, in the same replicated computation (its
# gradient, the same on every rank, is cut back to the rank's slice).
# Each is the identity on a model axis of size 1, or with
# no mesh installed; with grad mode off each is serving's collective
# (``tp_all_reduce``, ``tp_all_gather``), so the serving path and its
# CUDA graphs are unchanged. The mesh's reductions run in place, so each
# function reduces a copy: the tensors autograd saved, which a remat
# recompute reads, never change under it.

def _tp_ctx():
    ctx = _SHARD_CTX.get()
    return None if ctx is None or ctx["tp_size"] == 1 else ctx


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(), ctx.axis), None, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return mesh.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.contiguous(), ctx.dim, ctx.axes), \
            None, None, None


def copy_to_tp(x):
    """Forward the identity, backward an all-reduce over the model axis:
    the replicated input of a column-parallel product."""
    ctx = _tp_ctx()
    if ctx is None or not torch.is_grad_enabled():
        return x
    return _CopyToTP.apply(x, ctx["mesh"], ctx["tp"])


def reduce_from_tp(x):
    """Forward an all-reduce over the model axis, backward the identity:
    a row-parallel product's partial sums."""
    ctx = _tp_ctx()
    if ctx is None or not torch.is_grad_enabled():
        return tp_all_reduce(x)
    return _ReduceFromTP.apply(x, ctx["mesh"], ctx["tp"])


def gather_from_tp(x, dim: int = -1):
    """Forward an all-gather over the model axis along ``dim``, backward
    a reduce-scatter of the gradient back to this rank's slice."""
    ctx = _tp_ctx()
    if ctx is None or not torch.is_grad_enabled():
        return tp_all_gather(x, dim)
    return _GatherFromTP.apply(x, dim % x.dim(), ctx["mesh"], (ctx["tp"],))


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes):
        ctx.dim, ctx.n, ctx.r = dim, x.shape[dim], tp_rank()
        return mesh.all_gather(x, dim, axes)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.r * ctx.n, ctx.n).contiguous(), \
            None, None, None


def gather_whole(x, dim: int = -1):
    """Forward an all-gather over the model axis along ``dim``, backward
    this rank's slice of the gradient: a tensor every rank then uses
    whole in the same replicated computation (a column-parallel output
    joining the replicated stream), whose gradient is the same on every
    rank. ``gather_from_tp`` where each rank uses the whole in its own
    part."""
    ctx = _tp_ctx()
    if ctx is None or not torch.is_grad_enabled():
        return tp_all_gather(x, dim)
    return _GatherWhole.apply(x, dim % x.dim(), ctx["mesh"], (ctx["tp"],))


# --- FSDP ---------------------------------------------------------------------------
# A train step under a mesh keeps the leaves of the residency planner's
# streamed groups split over the data axis on their FSDP dim
# (``launch.sharding``), f32 like every master. ``fsdp_split`` names them
# for the model code, which gathers each whole where it uses it
# (``fsdp_leaf``): a block's leaves inside its remat function, so the
# backward's recompute gathers them again and only the running block's
# whole weights are live, as the reference's partitioner gathers a
# scanned layer's.

_FSDP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_fsdp", default=None)


@contextlib.contextmanager
def fsdp_split(dims: dict):
    """For the duration of the block, the leaves ``dims`` names (param
    path -> the dim the data axis splits) are this rank's slices, and
    ``fsdp_leaf`` gathers them; nothing is split where ``dims`` is
    empty."""
    token = _FSDP.set(dims or None)
    try:
        yield
    finally:
        _FSDP.reset(token)


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, dtype, mesh):
        ctx.dim, ctx.mesh, ctx.master = dim, mesh, x.dtype
        return mesh.all_gather(x.to(dtype), dim, ("data",))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g.to(ctx.master).contiguous(),
                                       ctx.dim, ("data",)), None, None, None


def fsdp_leaf(t, path: str, *, layer: bool = False):
    """``t``, the compute view's leaf at ``path``, whole. Where
    ``fsdp_split`` names it, this rank's f32 slice is cast to the compute
    dtype and all-gathered over data (the cast first: it is elementwise,
    so the bits are the cast of the gathered master, and half the bytes
    move), and its gradient comes back reduce-scattered over data in f32.
    ``layer``: ``t`` is one layer's view of a leaf stacked on a leading
    layer axis. ``t`` itself where nothing is split."""
    dims = _FSDP.get()
    d = None if dims is None else dims.get(path)
    if d is None:
        return t
    return _FsdpGather.apply(t, d - layer, COMPUTE_DTYPE, shard_mesh())


def fsdp_whole(tree: dict, prefix: str, *, layer: bool = False) -> dict:
    """``fsdp_leaf`` of each leaf of the dict ``tree``, the params'
    subtree at ``prefix`` (such as "blocks/")."""
    if _FSDP.get() is None:
        return tree
    return {k: fsdp_leaf(v, prefix + k, layer=layer)
            for k, v in tree.items()}


class _VocabParallelXent(torch.autograd.Function):
    """``softmax_xent`` over logits whose vocabulary is split across the
    model axis: the row's max and its sum of exponentials all-reduced
    (max, then sum), the label's logit contributed by the rank that owns
    it (summed with the exponentials); the backward is local: the
    softmax times (1 + 2 z lse), minus the label's one-hot within this
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, z_loss, mesh, axis, rank):
        V = logits.shape[-1]
        m = mesh.all_reduce(logits.amax(-1), axis, op="max")
        e = torch.exp(logits - m[..., None])
        idx = labels.long() - rank * V
        hit = (idx >= 0) & (idx < V)
        idx = idx.clamp(0, V - 1)
        own = torch.gather(logits, -1, idx[..., None])[..., 0] \
            * hit.to(logits.dtype)
        sums = mesh.all_reduce(torch.stack([e.sum(-1), own]), axis)
        lse = m + torch.log(sums[0])
        loss = lse - sums[1]
        if z_loss:
            loss = loss + z_loss * torch.square(lse)
        e.div_(sums[0][..., None])                     # the softmax
        ctx.save_for_backward(e, lse, idx, hit)
        ctx.z_loss = z_loss
        return loss

    @staticmethod
    def backward(ctx, g):
        p, lse, idx, hit = ctx.saved_tensors
        scale = g if not ctx.z_loss else g * (1 + 2 * ctx.z_loss * lse)
        d = p * scale[..., None]
        d.scatter_add_(-1, idx[..., None],
                       (-g * hit.to(g.dtype))[..., None])
        return d, None, None, None, None, None


def vocab_parallel_xent(logits_local, labels, *, z_loss=1e-4):
    """``softmax_xent`` of logits (..., V / tp) f32 holding this rank's
    slice of the vocabulary (rank r: columns r V/tp .. (r+1) V/tp), the
    same on every rank; ``softmax_xent`` itself on a model axis of size
    1."""
    ctx = _tp_ctx()
    if ctx is None:
        return softmax_xent(logits_local, labels, z_loss=z_loss)
    return _VocabParallelXent.apply(logits_local.float(), labels, z_loss,
                                    ctx["mesh"], ctx["tp"], tp_rank())


# --- tensor-parallel pieces the families share ------------------------------------

def embed_tokens(cfg, params, tokens):
    """The embedding rows of ``tokens`` from params["embed"] (``embed_rows``;
    an FSDP slice gathered at the lookup)."""
    return embed_rows(fsdp_leaf(params["embed"], "embed"), tokens,
                      cfg.vocab_size)


def embed_rows(w, tokens, vocab: int):
    """The rows of ``tokens`` in the embedding ``w``. Where ``w`` holds
    this rank's slice of the ``vocab`` rows, it looks the tokens up in
    its slice, zeros the others and sums over the model axis (exact: one
    nonzero a token)."""
    rows = w.shape[0]
    if rows == vocab:
        return w[tokens.long()]
    idx = tokens.long() - tp_rank() * rows
    hit = (idx >= 0) & (idx < rows)
    x = w[idx.clamp(0, rows - 1)] * hit[..., None].to(w.dtype)
    return reduce_from_tp(x)


def head_logits(h, w, vocab: int):
    """f32 logits of ``h`` through the head ``w`` (d, V): this rank's
    vocabulary columns where ``w`` holds a slice of the ``vocab``."""
    if w.shape[-1] != vocab:                 # column-parallel: a V slice
        h = copy_to_tp(h)
    return (h @ w).float()


def whole_vocab(logits, vocab: int):
    """``logits`` over the whole vocabulary on every rank, for a sampler:
    gathered over the model axis where they hold this rank's slice of the
    ``vocab`` columns; as they are where the head was left whole (a
    vocabulary the model axis does not divide)."""
    if logits.shape[-1] == vocab:
        return logits
    return tp_all_gather(logits, -1)


def reduce_rows(t, w, full: int):
    """A product through a row-parallel weight: its partial sums are
    summed over the model axis where ``w`` holds a slice of its ``full``
    input rows."""
    return reduce_from_tp(t) if w.shape[0] != full else t


def mean_xent(logits, labels, vocab: int):
    """The mean ``softmax_xent`` of ``logits``, vocabulary-parallel where
    they hold a rank's slice of the ``vocab`` columns."""
    if logits.shape[-1] != vocab:
        return torch.mean(vocab_parallel_xent(logits, labels))
    return torch.mean(softmax_xent(logits, labels))


def tp_part(x, dim: int = -1):
    """This rank's slice along ``dim`` of a tensor every model rank holds
    whole (a recurrent register's part, a replicated weight's columns);
    its gradient is this rank's part alone, so a replicated input is
    passed through ``copy_to_tp`` first. ``x`` itself on a model axis of
    size 1."""
    n = tp_size()
    if n == 1:
        return x
    size = x.shape[dim] // n
    return x.narrow(dim, tp_rank() * size, size)


# --- paged KV cache ---------------------------------------------------------------
# Page 0 of every pool is the pager's trash page: dead table slots and
# inactive decode slots point there, and attention lengths gate it out.

def paged_cache_init(num_layers: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int, dtype=COMPUTE_DTYPE,
                     device="cuda"):
    """(k_pages, v_pages), each (L, KV, P, page, dh), head-major so the
    decode kernel reads a layer's pool without relayout; on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    shape = (num_layers, kv_heads, num_pages, page_size, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def paged_cache_append(pages, new, page_ids, offsets):
    """Write one token per sequence into its page, in place: pages (KV, P,
    page, dh), new (B, KV, dh), page_ids/offsets (B,). Inactive slots
    point at the trash page (collisions there are harmless)."""
    pages[:, page_ids.long(), offsets.long()] = \
        new.transpose(0, 1).to(pages.dtype)


def paged_cache_write_prompt(pages, kv, page_ids):
    """Scatter a prefilled sequence into its pages, in place: pages (L,
    KV, P, page, dh), kv (L, S, KV, dh) with S a page multiple, page_ids
    (S/page,) (entries past the live pages point at the trash page)."""
    Lc, KVh, P, page, dh = pages.shape
    chunks = kv.reshape(Lc, -1, page, KVh, dh).permute(0, 3, 1, 2, 4)
    pages[:, :, page_ids.long()] = chunks.to(pages.dtype)


# --- initializers -------------------------------------------------------------

def seeded_generator(device, seed: int):
    """A ``torch.Generator`` on ``device`` seeded with ``seed``; None on
    ``meta``, where an init draws nothing (shapes only)."""
    if torch.device(device).type == "meta":
        return None
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def trunc_normal_(t, gen, std=0.02):
    """Fill ``t`` in place with std * N(0, 1) truncated to [-2, 2]."""
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def stack_layers(make_layer, n: int, device) -> dict:
    """``n`` draws of ``make_layer()`` (a nested dict of tensors) stacked
    on a leading layer axis, drawn one layer at a time so that only one
    layer's f32 temporaries are alive at once (n = 0: empty leaves of the
    layer's shapes)."""
    def empty_like(tree):
        return {k: empty_like(v) if isinstance(v, dict) else
                torch.empty((n, *v.shape), dtype=v.dtype, device=device)
                for k, v in tree.items()}

    def put(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                put(dst[k], v, i)
            else:
                dst[k][i] = v

    first = make_layer()
    out = empty_like(first)
    if n:
        put(out, first, 0)
    del first
    for i in range(1, n):
        put(out, make_layer(), i)
    return out


# --- norms ----------------------------------------------------------------------

def rmsnorm(x, scale=None, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dt)


def layernorm(x, scale=None, bias=None, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dt)


def make_norm(cfg):
    """Returns (init_fn(d, device) -> params, apply_fn(x, p) -> x)."""
    if cfg.norm == "rmsnorm":
        return (lambda d, device: torch.ones(d, dtype=PARAM_DTYPE,
                                             device=device),
                lambda x, p: rmsnorm(x, p))
    if cfg.norm == "layernorm":
        return (lambda d, device: torch.ones(d, dtype=PARAM_DTYPE,
                                             device=device),
                lambda x, p: layernorm(x, p))
    # olmo: non-parametric LN — no learnable affine at all
    return (lambda d, device: torch.zeros(0, dtype=PARAM_DTYPE,
                                          device=device),
            lambda x, p: layernorm(x, None))


# --- rotary embeddings ----------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu"):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, each (B, S, 1, dh/2) f32 — one
    pair serves every layer of a forward."""
    freqs = rope_freqs(head_dim, theta, positions.device)       # (half,)
    angles = positions[..., None].float() * freqs              # (B,S,half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def rotate(x, cos, sin):
    """Apply precomputed rotary angles to x (B, S, H, dh)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (B, S, H, dh); positions: (B, S) int."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta))


def mrope_sections(head_dim: int) -> tuple[int, int, int]:
    """Qwen2-VL M-RoPE splits the half-dim into (temporal, height, width)
    sections; for dh=128 the split is (16, 24, 24)."""
    half = head_dim // 2
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h


def mrope_cos_sin(positions3, head_dim: int, theta: float):
    """(cos, sin) of the M-RoPE angles, each (B, S, 1, dh/2) f32, from
    ``positions3`` (3, B, S) int: section i of the frequencies turns with
    position row i (t, h, w). Three equal rows give ``rope_cos_sin``."""
    freqs = rope_freqs(head_dim, theta, positions3.device)
    parts, off = [], 0
    for i, s in enumerate(mrope_sections(head_dim)):
        parts.append(positions3[i][..., None].float() * freqs[off:off + s])
        off += s
    angles = torch.cat(parts, dim=-1)                          # (B,S,half)
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_mrope(x, positions3, theta):
    """x: (B, S, H, dh); positions3: (3, B, S) int (t/h/w position ids)."""
    return rotate(x, *mrope_cos_sin(positions3, x.shape[-1], theta))


# --- attention core --------------------------------------------------------------

def gqa_attention(q, k, v, *, mask=None, scale=None):
    """Grouped-query attention with an explicit mask.

    q: (B, S, H, dh); k, v: (B, T, KV, dh); H % KV == 0.
    mask: broadcastable to (B, KV, G, S, T); True = keep.
    """
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(B, S, KV, G, dh)
    logits = (torch.einsum("bskgd,btkd->bkgst", qg, k) * scale).float()
    if mask is not None:
        logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, dh)


def chunked_attention(q, k, v, *, causal=True, window=0, scale=None,
                      q_chunk=1024, q_offset=0):
    """GQA attention that never materializes the full (S, T) scores:
    a loop over query chunks with per-chunk masks. K/V are expanded
    from KV to H heads first, as in the reference.

    q: (B, S, H, dh); k, v: (B, T, KV, dh). Query row i is at absolute
    position q_offset + i; key j at position j.
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if S % q_chunk:
        q_chunk = math.gcd(S, q_chunk) or S
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)          # (B, T, H, dh)
        v = torch.repeat_interleave(v, G, dim=2)
    kj = torch.arange(T, device=q.device)[None, :]
    outs = []
    for i in range(S // q_chunk):
        qc = q[:, i * q_chunk:(i + 1) * q_chunk].transpose(1, 2)
        logits = (torch.einsum("bhsd,bthd->bhst", qc, k) * scale).float()
        qi = (i * q_chunk + torch.arange(q_chunk, device=q.device))[:, None] \
            + q_offset
        m = torch.ones((q_chunk, T), dtype=torch.bool, device=q.device)
        if causal:
            m &= kj <= qi
        if window:
            m &= kj > qi - window
        logits = logits.masked_fill(~m, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bhst,bthd->bshd", probs, v))
    return torch.cat(outs, dim=1)


def causal_mask(s: int, t: int, *, q_offset=0, device="cpu"):
    """(1,1,1,S,T) boolean causal mask; q position i attends to j <= i+off."""
    qi = torch.arange(s, device=device)[:, None] + q_offset
    kj = torch.arange(t, device=device)[None, :]
    return (kj <= qi)[None, None, None]


def window_mask(s: int, t: int, window: int, *, q_offset=0, device="cpu"):
    qi = torch.arange(s, device=device)[:, None] + q_offset
    kj = torch.arange(t, device=device)[None, :]
    return ((kj <= qi) & (kj > qi - window))[None, None, None]


def valid_mask_from_length(t: int, length):
    """(B,1,1,1,T): cache positions < length are valid (decode)."""
    kj = torch.arange(t, device=length.device)[None, :]
    return (kj < length[:, None])[:, None, None, None, :]


# --- FFN -----------------------------------------------------------------------

def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down, d_ff: int | None = None):
    """Whisper's MLP: tanh-approximate GELU between two biased products;
    where ``w_down`` holds a slice of its ``d_ff`` input rows (row-parallel)
    its partial sums are summed over the model axis before its bias."""
    f = F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down
    return reduce_rows(f, w_down, d_ff or w_down.shape[0]) + b_down


# --- MoE (capacity-based dispatch) ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEDims:
    num_experts: int
    top_k: int
    capacity: int


def moe_dims(cfg, n_tokens: int) -> MoEDims:
    """Expert-capacity ceiling for routing ``n_tokens`` tokens, a Python
    int known on the host. ``n_tokens`` must be the EXACT live token
    count, not a padded shape (serving paths pass the exact-length
    capacity as ``route_capacity``)."""
    m = cfg.moe
    cap = int(math.ceil(n_tokens / m.num_experts * m.capacity_factor
                        * m.top_k))
    cap = max(cap, 4)
    # the reference aligns capacity to its 128-lane tile past 128 tokens
    cap = (cap + 127) // 128 * 128 if n_tokens >= 128 else cap
    return MoEDims(m.num_experts, m.top_k, cap)


def moe_dims_dropless(cfg, n_tokens: int) -> MoEDims:
    """Decode dims whose capacity no routing can overflow: a decode batch
    holds one token of each of ``n_tokens`` independent requests, and a
    slot's output may never depend on its neighbours."""
    m = cfg.moe
    return MoEDims(m.num_experts, m.top_k, max(n_tokens, 4))


class _Dispatch(torch.autograd.Function):
    """The MoE dispatch: x (N, D) into a flat (R, D) expert batch, zeros
    but row ``row[i]`` = x[src[i]] for each claim i in expert order (the
    last row R - 1 is the trash of dropped claims). Its backward sums each
    token's K claim rows (``row_nk`` (N, K), its claims' rows in token
    order) in ascending row, so expert, order: one gather and K - 1 adds
    in x's dtype, as the forward's combine adds. Autograd's own backward
    of ``x[src]`` would sort every index to scatter-add them."""

    @staticmethod
    def forward(ctx, x, src, row, row_nk, R):
        ctx.save_for_backward(row_nk)
        out = torch.zeros((R, x.shape[1]), dtype=x.dtype, device=x.device)
        out[row] = x[src]
        return out

    @staticmethod
    def backward(ctx, g):
        (row_nk,) = ctx.saved_tensors
        ordered = torch.sort(row_nk, dim=-1).values
        gx = g[ordered[:, 0]]
        for k in range(1, ordered.shape[1]):
            gx = gx + g[ordered[:, k]]
        return gx, None, None, None, None


class _Combine(torch.autograd.Function):
    """The MoE combine's gather: the expert outputs ye (R - 1, D) at each
    token's claim rows ``row_nk`` (N, K) -> (N, K, D), the trash row R - 1
    reading zeros. The rows of kept claims are distinct, so the backward
    writes each claim's gradient to its row (the trash row's is dropped):
    no scatter-add, no sort."""

    @staticmethod
    def forward(ctx, ye, row_nk):
        ctx.save_for_backward(row_nk)
        ctx.rows = ye.shape[0]
        pad = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
        return pad[row_nk]

    @staticmethod
    def backward(ctx, g):
        (row_nk,) = ctx.saved_tensors
        out = g.new_zeros((ctx.rows + 1, g.shape[-1]))
        out[row_nk.reshape(-1)] = g.reshape(-1, g.shape[-1])
        return out[:-1], None


def load_balance_loss(probs, gate_idx, num_experts: int):
    """The Switch-style auxiliary load-balancing loss of the reference's
    ``_load_balance_loss``: E x sum over experts of (mean router
    probability) x (share of tokens whose top-1 pick it is), in f32. The
    top-1 counts come from a ``scatter_add_`` (no host read); only the
    mean probabilities carry a gradient."""
    N = probs.shape[0]
    top1 = gate_idx[:, 0]
    hits = torch.zeros(num_experts, dtype=torch.float32,
                       device=probs.device).scatter_add_(
        0, top1, torch.ones_like(top1, dtype=torch.float32))
    return num_experts * torch.sum(probs.float().mean(0) * (hits / N))


def moe_ffn(x2d, p, dims: MoEDims, *, keep_override=None,
            return_keep=False, return_aux=False):
    """Sort/scatter dispatch -> grouped SwiGLU -> combine: the reference's
    ``moe_ffn``, its data-parallel groups and its expert parallelism.

    Top-k softmax routing over ``p["router"]`` (rounded weights, f32
    product); each (token, slot) claim takes the next queue position of
    its expert in token order, and claims past the capacity drop.
    ``keep_override`` ((N, k) bool) replays a recorded drop population:
    forced-drop claims never queue, forced-keep claims take positions
    counted over the forced-keep claims only. ``return_keep`` appends the
    realized (N, k) keep mask, then ``return_aux`` the 0-d f32
    ``load_balance_loss`` of this routing (training asks for it; serving
    does not, so its device work is unchanged).

    Groups: with G = ``dp_group_count()`` > 1 the tokens dispatch within
    G groups of N/G rows at capacity ``dims.capacity`` / G each, as the
    reference's group-local dispatch does, unless the tokens or the
    capacity do not divide into G (then one group, the reference's
    fallback). Under an installed mesh ``x2d`` holds this data rank's
    rows, which are its group, and ``dims`` are the whole batch's
    (``global_tokens``); in the fallback every data rank dispatches the
    whole batch, gathered over the data axes, and keeps its rows. Without
    a mesh ``x2d`` holds every group's rows, one after the other.

    Expert parallelism: where ``p``'s expert weights hold this rank's
    slice of the experts (E / tp of them, split over the model axis),
    every model rank routes the same tokens with the replicated router,
    builds the (E / tp, C, D) batch of its own experts and combines its
    experts' weighted outputs alone: the output is this rank's part of
    the sum, which the caller sums over the model axis
    (``tp_all_reduce``, with its other row-parallel parts).

    Every step stays on the device with no host read: expert counts come
    from a ``scatter_add_`` (``bincount`` would read its max back), the
    expert sort is a stable argsort, and each token's k weighted expert
    outputs are summed in ascending expert order in x's dtype — the
    reference's scatter-add order and rounding — instead of through
    ``index_add_``'s atomics. The expert batch runs through
    ``ops.moe_expert_ffn``, three grouped-GEMM launches, told each
    expert's kept claims (a ``scatter_add_`` of the keep mask): the kept
    claims of an expert fill rows 0 .. n - 1 of its batch, the rows past
    them are zeros and stay zeros through the SwiGLU, so the products
    skip them (and an expert with none) without changing the result.
    """
    N = x2d.shape[0]
    E, K, C = dims.num_experts, dims.top_k, dims.capacity
    G = dp_group_count()
    local = G > 1 and shard_mesh() is not None     # x2d: one group's rows
    if (N * G if local else N) % G or C % G:
        G = 1
    probs = torch.softmax(x2d.float() @ p["router"].float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)          # (N, K)
    if G == 1 and local:
        # the capacity is the whole batch's: dispatch it as one group
        x_all = dp_all_gather(x2d, 0)
        ko = None if keep_override is None else dp_all_gather(keep_override,
                                                              0)
        vals, idx = torch.topk(torch.softmax(
            x_all.float() @ p["router"].float(), dim=-1), K, dim=-1)
        y, keep_nk = _dispatch_ffn(x_all, p, E, C, vals, idx, ko)
        rows = slice(dp_rank() * N, (dp_rank() + 1) * N)
        y, keep_nk = y[rows], keep_nk[rows]
    elif G == 1 or local:
        y, keep_nk = _dispatch_ffn(x2d, p, E, C // G, gate_vals, gate_idx,
                                   keep_override)
    else:                               # every group's rows in this process
        n = N // G
        parts = [_dispatch_ffn(
            x2d[g * n:(g + 1) * n], p, E, C // G,
            gate_vals[g * n:(g + 1) * n], gate_idx[g * n:(g + 1) * n],
            None if keep_override is None
            else keep_override[g * n:(g + 1) * n]) for g in range(G)]
        y = torch.cat([y for y, _ in parts])
        keep_nk = torch.cat([k for _, k in parts])
    out = (y, *((keep_nk,) if return_keep else ()),
           *((load_balance_loss(probs, gate_idx, E),) if return_aux else ()))
    return out if len(out) > 1 else y


def _dispatch_ffn(x2d, p, E: int, C: int, gate_vals, gate_idx,
                  keep_override):
    """One group's dispatch at capacity ``C``, its experts' SwiGLU and the
    combine (``moe_ffn``): (y (N, D), the keep mask (N, k)); y is this
    rank's part where ``p`` holds a slice of the experts."""
    N, D = x2d.shape
    K = gate_idx.shape[1]
    dev = x2d.device
    e_flat = gate_idx.reshape(N * K)
    t_flat = torch.arange(N * K, device=dev) // K
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.zeros(E, dtype=torch.long, device=dev).scatter_add_(
        0, e_flat, torch.ones_like(e_flat))
    offsets = torch.cumsum(counts, 0) - counts                  # (E,)
    if keep_override is None:
        pos = torch.arange(N * K, device=dev) - offsets[e_sorted]
        keep = pos < C
    else:
        # replay: queue positions counted over forced-keep claims only
        f_sorted = keep_override.reshape(N * K)[order]
        fi = f_sorted.long()
        csum = torch.cumsum(fi, 0) - fi                         # exclusive
        starts = torch.cat([csum, fi.sum()[None]])[offsets]
        pos = csum - starts[e_sorted]
        keep = f_sorted & (pos < C)
    # row e * C + pos of the flat (E * C + 1, D) batch; dropped claims go
    # to the trash row E * C, which the expert batch never sees
    row = torch.where(keep, e_sorted * C + pos, E * C)
    rows = torch.zeros(E, dtype=torch.int32, device=dev).scatter_add_(
        0, e_sorted, keep.to(torch.int32))
    El = p["w_gate"].shape[0]
    if El != E:
        # this rank's experts lo .. lo + El - 1 alone: the other claims go
        # to the trash row, whose output reads zeros
        lo = tp_rank() * El
        mine = (row >= lo * C) & (row < (lo + El) * C)
        row = torch.where(mine, row - lo * C, El * C)
        rows = rows[lo:lo + El]
    inv = torch.argsort(order)
    row_nk = row[inv].reshape(N, K)             # (token, slot) order
    xe = _Dispatch.apply(x2d, t_flat[order], row, row_nk, El * C + 1)
    ye = ops.moe_expert_ffn(xe[:El * C].view(El, C, D), p["w_gate"],
                            p["w_up"], p["w_down"], rows)       # (El, C, D)
    # back to (token, slot) order, then each token's slots by expert id
    keep_nk = keep[inv].reshape(N, K)
    y_nk = _Combine.apply(ye.view(El * C, D), row_nk)
    w_nk = (gate_vals * keep_nk).to(x2d.dtype)
    by_expert = torch.argsort(gate_idx, dim=-1)
    contrib = torch.gather(y_nk * w_nk[..., None], 1,
                           by_expert[..., None].expand(N, K, D))
    y = contrib[:, 0]
    for k in range(1, K):
        y = y + contrib[:, k]
    return y, keep_nk


def init_moe_params(cfg, d_model: int, gen, device):
    """One layer's MoE params, the reference's distributions: router and
    shared experts std 1/sqrt(d_in), routed experts 1/sqrt(d_model) (gate,
    up) and 1/sqrt(d_ff_expert) (down). Stored in bf16."""
    m = cfg.moe
    E, Fe = m.num_experts, m.d_ff_expert

    def normal(shape, std):
        t = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
        return trunc_normal_(t, gen, std).to(COMPUTE_DTYPE)

    p = {"router": normal((d_model, E), 1.0 / math.sqrt(d_model)),
         "w_gate": normal((E, d_model, Fe), 1.0 / math.sqrt(d_model)),
         "w_up": normal((E, d_model, Fe), 1.0 / math.sqrt(d_model)),
         "w_down": normal((E, Fe, d_model), 1.0 / math.sqrt(Fe))}
    if m.num_shared_experts:
        Fs = Fe * m.num_shared_experts
        p["shared_gate"] = normal((d_model, Fs), 1.0 / math.sqrt(d_model))
        p["shared_up"] = normal((d_model, Fs), 1.0 / math.sqrt(d_model))
        p["shared_down"] = normal((Fs, d_model), 1.0 / math.sqrt(Fs))
    return p


# --- multi-step decode fusion ----------------------------------------------------

def decode_loop_step(step_fn, step, pending, lengths, remaining, page_table,
                     mask, teacher, use_teacher, out) -> None:
    """One iteration of the fused horizon, every operand a device tensor,
    so the same code runs in ``multi_step_decode``'s loop and inside a
    captured CUDA graph (``runtime.DecodeGraph``).

    ``step`` (1,) int64 is the step index and advances by one; ``out``
    (hmax, B) int32 takes row ``step``. Slots in ``mask`` with budget
    left are live: they feed ``pending`` at ``lengths``, sample greedily
    (``teacher[step]`` instead where ``use_teacher``, a bool scalar) and
    advance ``pending``, ``lengths`` and ``remaining`` in place; the others
    feed token 0 at length 0 and keep their state. ``page_table`` is
    already masked to the trash page for slots outside ``mask``."""
    live = mask & (remaining > 0)
    toks = torch.where(live, pending, 0)
    lens = torch.where(live, lengths, 0)
    logits = step_fn(toks, page_table, lens, live)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    forced = teacher.index_select(0, step)[0].to(torch.int32)
    nxt = torch.where(use_teacher, forced, nxt)
    pending.copy_(torch.where(live, nxt, pending))
    out.index_copy_(0, step, torch.where(live, nxt, 0)[None])
    took = live.to(torch.int32)
    lengths.add_(took)
    remaining.sub_(took)
    step.add_(1)


def multi_step_decode(step_fn, hmax: int, pending, lengths, remaining,
                      page_table, mask, h: int, teacher=None):
    """Run ``h`` decode steps of ``step_fn`` with the token feedback on
    the device: greedy argmax, the pending-token carry, length/remaining
    advancement and end-of-budget masking all stay device-side, so the
    host syncs once per horizon (when it reads the returned tokens).

    ``step_fn(tokens, page_table, lengths, active) -> logits`` is one
    paged decode step that updates its KV pool in place. ``pending``,
    ``lengths`` and ``remaining`` (B,) int32 are the engine's persistent
    loop tensors and advance in place (the reference donates them).
    ``mask`` (B,) bool selects the slots this call advances; a slot also
    drops out when its ``remaining`` budget hits zero. Inactive slots
    feed token 0 and write to the trash page (page 0). ``teacher``
    ((hmax, B) int32 or None) forces the fed-back token per step.
    Returns the (hmax, B) int32 token buffer; rows past ``h`` (or past a
    slot's budget) are 0. The loop body is ``decode_loop_step``.
    """
    B, dev = pending.shape[0], pending.device
    pt = torch.where(mask[:, None], page_table, 0)
    out = torch.zeros((hmax, B), dtype=torch.int32, device=dev)
    step = torch.zeros((1,), dtype=torch.long, device=dev)
    use_teacher = torch.full((), teacher is not None, dtype=torch.bool,
                             device=dev)
    if teacher is None:
        teacher = out           # never selected
    for _ in range(h):
        decode_loop_step(step_fn, step, pending, lengths, remaining, pt,
                         mask, teacher, use_teacher, out)
    return out


# --- training ------------------------------------------------------------------------

def layer_views(tree, n: int) -> list:
    """The ``n`` per-layer views of a tree stacked on a leading layer
    axis, by one ``unbind`` a leaf: its backward stacks the layers'
    gradients once, where indexing layer by layer would add a full-size
    zero gradient for every layer (quadratic in depth)."""
    cols = {k: layer_views(v, n) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def checkpointed(fn, *args, remat: bool):
    """``fn(*args)``; with ``remat`` under autograd its activations are
    dropped and recomputed in the backward from ``args`` alone — the
    reference's ``jax.checkpoint(body, policy=nothing_saveable)`` around
    each scanned block."""
    if remat and torch.is_grad_enabled():
        # the recompute may run on autograd's device thread, which has no
        # context of its own: it runs in a copy of this one, so the shard
        # context and the FSDP split hold there as in the forward
        return torch.utils.checkpoint.checkpoint(
            contextvars.copy_context().run, fn, *args, use_reentrant=False)
    return fn(*args)


def softmax_xent(logits, labels, *, z_loss=1e-4):
    """Cross-entropy with z-loss; logits (..., V) f32, labels (...) int:
    logsumexp - the label's logit, plus z_loss * logsumexp^2."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss
