"""Sharding rules of the port: parameter, optimizer, batch and
decode-state specs, and the rank-local slices they name.

The rule table is the reference's (``repro.launch.sharding``), copied
verbatim. The rule engine classifies every parameter leaf by the last
component of its tree path, then builds a spec from the leaf's rank:

    col     column-parallel matmul weight  -> shard dim -1 over model
    row     row-parallel matmul weight     -> shard dim -2 over model
    ep      stacked expert / head weight   -> shard dim  1 over model
    vocab   embedding table                -> shard dim  0 over model
    chan    per-channel vector             -> shard dim -1 over model
    rep     replicate

Residency-streamed tensors additionally shard their complementary
matmul dimension over the data axis (FSDP). A spec is a ``P``: a tuple
with one entry per tensor dimension, each an axis name, a tuple of axis
names (the first the major one) or None, so it compares element by
element with the reference's ``PartitionSpec``.

Where the reference hands its specs to XLA's partitioner, the port runs
rank-locally: ``shard_tree`` keeps a rank's slice of each leaf (the
param trees have the reference's names and layouts, so the specs apply
leaf for leaf), and ``local_init`` lets a model's ``init_params`` keep
only that slice of each drawn matrix. ``gather_leaf`` puts one leaf's
slices back together, for a checkpoint; ``fsdp_dim`` and
``replication`` tell the train step which leaves FSDP splits and how
many ranks hold each element of a leaf.
"""

from __future__ import annotations

import dataclasses
import math
import re

from .mesh import dp_axes


class P(tuple):
    """A partition spec: one entry per dimension (axis name, tuple of
    axis names, or None)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# --- classification table ---------------------------------------------------------

# last path component -> rule
_RULES: dict[str, str] = {
    # column-parallel (output dim sharded)
    "wq": "col", "wk": "col", "wv": "col", "w_gate": "col", "w_up": "col",
    "x_wq": "col", "x_wk": "col", "x_wv": "col",
    "wr": "col", "wg": "col", "ffn_k": "col", "ffn_r": "col",
    "w_lora_a": "col", "w_lora_b": "col",
    "w_dkv": "col", "w_kr": "col", "patch_proj": "col",
    "w_x": "col", "w_i": "col", "w_branch": "col",
    "mix_w2": "col",
    # tiny full-D vectors/loras consumed elementwise: replicate so the
    # ddlerp base term stays local (§Perf iteration A2)
    "mix_w1": "rep", "mu_base": "rep", "mu_ffn": "rep",
    # row-parallel (input dim sharded)
    "wo": "row", "w_down": "row", "w_out": "row", "ffn_v": "row",
    "x_wo": "row",
    # expert / head stacked (dim 1 sharded)
    "u": "ep",
    # embeddings
    "embed": "vocab", "lm_head": "col",
    # per-channel vectors aligned with col-sharded outputs
    "bq": "chan", "bk": "chan", "bv": "chan", "b_up": "chan",
    "x_bq": "chan", "x_bv": "chan",
    "w_base": "chan", "gn": "chan", "gnb": "chan",
    "lam": "chan", "b_i": "chan", "b_r": "chan", "conv_w": "chan",
    "conv_b": "chan",
    # replicated
    "router": "rep", "enc_pos": "rep", "dec_pos": "rep",
}

# tensors under a `moe/` prefix use expert parallelism on the E axis
_MOE_EP = {"w_gate": "ep", "w_up": "ep", "w_down": "ep"}
# deepseek MLA per-head up-projections (L, H, r, d)
_HEAD_EP = {"w_uk": "ep", "w_uv": "ep"}


def _leaf_rule(path: tuple[str, ...]) -> str:
    name = path[-1]
    if len(path) >= 2 and path[-2] == "moe" and name in _MOE_EP:
        return _MOE_EP[name]
    if name in _HEAD_EP:
        return _HEAD_EP[name]
    if name.startswith("shared_"):
        return "col" if name in ("shared_gate", "shared_up") else "row"
    return _RULES.get(name, "rep")


def _spec_for(rule: str, ndim: int, tp, fsdp_axis: str | None,
              shape: tuple[int, ...], tp_size: int, dp_size: int) -> P:
    """The spec of one leaf, checking divisibility (a dim that does not
    divide its axis stays whole, as in the reference)."""
    dims: list = [None] * ndim

    def ok(d, size):
        return shape[d] % size == 0 and shape[d] >= size

    if rule == "col" and ndim >= 2 and ok(ndim - 1, tp_size):
        dims[ndim - 1] = tp
        if fsdp_axis and ok(ndim - 2, dp_size):
            dims[ndim - 2] = fsdp_axis
    elif rule == "row" and ndim >= 2 and ok(ndim - 2, tp_size):
        dims[ndim - 2] = tp
        if fsdp_axis and ok(ndim - 1, dp_size):
            dims[ndim - 1] = fsdp_axis
    elif rule == "ep" and ndim >= 2 and ok(1, tp_size):
        dims[1] = tp
        if fsdp_axis and ndim >= 3 and ok(2, dp_size):
            dims[2] = fsdp_axis
    elif rule == "vocab" and ok(0, tp_size):
        dims[0] = tp
        if fsdp_axis and ndim >= 2 and ok(1, dp_size):
            dims[1] = fsdp_axis
    elif rule == "chan" and ok(ndim - 1, tp_size):
        dims[ndim - 1] = tp
    return P(*dims)


# residency tensor-group name -> param path patterns
_GROUP_PATTERNS = {
    "embed": [r"^embed$"],
    "lm_head": [r"^lm_head$"],
    "attn": [r"(^|/)(wq|wk|wv|wo|w_dkv|w_kr|w_uk|w_uv|x_w.)$"],
    "ffn": [r"(^|/)(w_gate|w_up|w_down|ffn_.)$"],
    "experts": [r"moe/(w_gate|w_up|w_down)$"],
    "shared_experts": [r"moe/shared_"],
    "recurrent": [r"(^|/)(w_x|w_i|w_branch|w_out|conv_w|lam)$"],
    "att_proj": [r"(^|/)(wr|wg)$"],
    "mixers": [r"(^|/)(mix_w|w_lora|mu_)"],
    "encoder": [r"^enc_blocks/"],
    "cross_attn": [r"/x_w"],
}


def _streamed(path_str: str, streamed_groups: frozenset[str]) -> bool:
    for g in streamed_groups:
        for pat in _GROUP_PATTERNS.get(g, []):
            if re.search(pat, path_str):
                return True
    return False


# --- trees -------------------------------------------------------------------------
# A tree is nested dicts, lists/tuples and dataclasses over leaves (tensors,
# or anything with a ``.shape``; an int is a 0-d leaf). The path of a leaf
# is its keys, indices and field names from the root.

def flatten(tree, path=()):
    if isinstance(tree, P):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten(v, (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten(v, (*path, str(i)))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from flatten(getattr(tree, f.name), (*path, f.name))
    else:
        yield path, tree


def tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree (a ``P`` is a leaf), keeping its
    structure."""
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, (*path, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, (*path, str(i)))
                          for i, v in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name), (*path, f.name))
            for f in dataclasses.fields(tree)})
    return fn(path, tree)


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def leaf_at(tree, path):
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif isinstance(tree, (list, tuple)):
            tree = tree[int(k)]
        else:
            tree = getattr(tree, k)
    return tree


# --- parameter specs ---------------------------------------------------------------

def param_pspecs(param_shapes, mesh, *,
                 streamed_groups: frozenset[str] = frozenset(),
                 wide_tp: bool = False):
    """A tree of ``P`` matching ``param_shapes`` (a param tree of tensors,
    meta tensors included).

    ``wide_tp`` shards the tensor-parallel dim over both mesh axes (model
    x data): the reference's serving topology for models whose bf16
    weights exceed HBM at 16-way TP. Streamed groups are ignored then.
    """
    tp = ("model", "data") if wide_tp else "model"
    tp_size = mesh.shape["model"] * (mesh.shape.get("data", 1)
                                     if wide_tp else 1)
    dp_size = mesh.shape.get("data", 1)

    def spec(path, leaf):
        fsdp = "data" if (not wide_tp and
                          _streamed("/".join(path), streamed_groups)) \
            else None
        shape = _shape(leaf)
        return _spec_for(_leaf_rule(path), len(shape), tp, fsdp, shape,
                         tp_size, dp_size)
    return tree_map(spec, param_shapes)


# --- batch & state ------------------------------------------------------------------

def batch_dim_spec(size: int, mesh):
    """Largest prefix of (pod, data) that divides ``size`` (batch dim)."""
    axes = []
    prod = 1
    for a in dp_axes(mesh):
        n = mesh.shape[a]
        if size % (prod * n) == 0:
            axes.append(a)
            prod *= n
    if not axes:
        return None
    return tuple(axes) if len(axes) > 1 else axes[0]


def batch_pspecs(batch_shapes, mesh):
    """tokens/labels (B, S) etc: shard dim 0 over the data axes."""
    def spec(_, leaf):
        shape = _shape(leaf)
        return P(batch_dim_spec(shape[0], mesh), *([None] * (len(shape) - 1)))
    return tree_map(spec, batch_shapes)


# decode-state field rules: last path component -> (batch_dim, model_dims)
# model_dims: candidate axes counted from the END, tried in order (the
# first divisible one is sharded) — KV caches prefer the head axis (-2,
# aligned with q-head TP after serve_kv_expand) and fall back to dh.
_STATE_RULES: dict[str, tuple[int | None, tuple[int, ...]]] = {
    "k": (1, (-2, -1)), "v": (1, (-2, -1)),   # (L, B, T, KVe, dh)
    "kv": (None, (-2, -1)),                   # stacked/latent: see below
    "wkv": (1, (2,)),                         # (L, B, H, dh, dh): heads
    "att_prev": (1, (-1,)), "ffn_prev": (1, (-1,)),
    "h": (1, (-1,)), "conv": (1, (-1,)),      # RG-LRU channels
    "kpos": (1, ()),
    "enc_out": (0, ()),
    "pos": (None, ()),
}


def state_pspecs(state_shapes, mesh):
    tp_size = mesh.shape["model"]

    def spec(path, leaf):
        name = path[-1].lstrip(".")
        shape = _shape(leaf)
        ndim = len(shape)
        bdim, mdims = _STATE_RULES.get(name, (None, ()))
        dims: list = [None] * ndim
        if name == "kv":          # (2,L,B,T,KV,dh) stacked or (L,B,T,r) MLA
            bdim = 2 if ndim == 6 else 1
            mdims = (-2, -1) if ndim == 6 else (-1,)
        for mdim in mdims:
            d = mdim % ndim
            if shape[d] % tp_size == 0 and shape[d] >= tp_size:
                dims[d] = "model"
                break
        if bdim is not None and ndim:
            b = batch_dim_spec(shape[bdim], mesh)
            if b is not None:
                dims[bdim] = b
        return P(*dims)
    return tree_map(spec, state_shapes)


def opt_pspecs(param_pspec_tree, mesh):
    """OptState(step, m, v): moments shard like their parameters."""
    from ..optim import OptState
    return OptState(step=P(), m=param_pspec_tree, v=param_pspec_tree)


# --- placements and local slices ----------------------------------------------------

def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_shardings(pspec_tree, mesh):
    """Each spec as ``DTensor`` placements, one a mesh dimension:
    ``Shard(d)`` where tensor dim d is split over that mesh axis, else
    ``Replicate()``. A dim split over several axes must name them in the
    mesh's order (DTensor splits mesh dimension by mesh dimension)."""
    from torch.distributed.tensor import Replicate, Shard

    def placements(_, spec):
        out = [Replicate()] * len(mesh.axis_names)
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            order = [mesh.axis_names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"dim {d} of {spec} splits over {axes}, "
                                 f"against the mesh's order "
                                 f"{mesh.axis_names}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)
    return tree_map(placements, pspec_tree)


def shard_index(entry, mesh) -> tuple[int, int]:
    """(number of shards, this rank's shard index) of one spec entry: the
    first axis named is the major one, as in the reference."""
    n, idx = 1, 0
    for a in _axes(entry):
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.coords[a]
    return n, idx


def local_shape(shape, spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's slice of a tensor of ``shape``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        n, _ = shard_index(entry, mesh)
        if out[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                             f"into {n} shards ({spec})")
        out[d] //= n
    return tuple(out)


def local_slice(t, spec, mesh):
    """This rank's slice of ``t`` under ``spec`` (a view; ``t`` itself
    when nothing is split)."""
    for d, entry in enumerate(spec):
        n, idx = shard_index(entry, mesh)
        if n > 1:
            size = t.shape[d] // n
            t = t.narrow(d, idx * size, size)
    return t


def split_axes(spec) -> tuple[str, ...]:
    """The mesh axes a leaf is split on, in its dims' order."""
    return tuple(a for entry in spec for a in _axes(entry))


def fsdp_dim(spec) -> int | None:
    """The dim FSDP splits over the data axis (``_spec_for``'s
    ``fsdp_axis``), or None."""
    for d, entry in enumerate(spec):
        if entry == "data":
            return d
    return None


def replication(spec, mesh) -> int:
    """How many ranks of ``mesh`` hold each element of a leaf under
    ``spec``: the product of the axes it is not split on."""
    return math.prod(mesh.shape.values()) // math.prod(
        mesh.shape[a] for a in split_axes(spec))


def gather_leaf(leaf, spec, mesh, *, keep: bool = True):
    """A host copy of the whole tensor of ``leaf``, this rank's slice
    under ``spec``: gathered over the axes the spec splits (every rank of
    ``mesh`` must call it), copied to the host where ``keep``, else
    dropped (None). A non-tensor leaf comes back as it is."""
    if not hasattr(leaf, "narrow"):
        return leaf
    t = leaf.detach()
    for d, entry in enumerate(spec):
        if entry is not None:
            t = mesh.all_gather(t, d, _axes(entry))
    return t.to("cpu", copy=True) if keep else None


def shard_tree(tree, specs, mesh):
    """Keep this rank's slice of every leaf (a contiguous copy where the
    leaf is split; ints and 0-d leaves as they are)."""
    def one(path, leaf):
        spec = leaf_at(specs, path)
        if not hasattr(leaf, "narrow") or not len(spec):
            return leaf
        part = local_slice(leaf, spec, mesh)
        return part.contiguous().clone() if part is not leaf else leaf
    return tree_map(one, tree)


def local_init(specs, mesh):
    """The hook a model's ``init_params(..., local=)`` calls on every drawn
    tensor: ``fn(path, t)`` keeps this rank's slice of ``t``, where ``t``
    is the whole leaf at ``path`` or one layer of a leaf stacked on a
    leading layer axis (whose spec then drops its first entry)."""
    def keep(path, t):
        spec = leaf_at(specs, path)
        if t.dim() == len(spec) - 1:
            if spec[0] is not None:
                raise ValueError(f"{'/'.join(path)}: the layer axis is "
                                 f"split ({spec})")
            spec = P(*spec[1:])
        part = local_slice(t, spec, mesh)
        return part.clone() if part is not t else t
    return keep
