"""MoE decoders in PyTorch: MLA-MoE (deepseek-v2-lite-16b) and GQA-MoE
(olmoe-1b-7b).

Counterpart of ``repro.models.moe``. The MLA branch: multi-head latent
attention (the cache holds one compressed latent row of kv_lora_rank +
rope head per token, and W_uk / W_uv are absorbed into the query and
output side). The GQA branch: the dense model's grouped-query attention
(``transformer._qkv``), its static cache stacked as (2, L, B, T, KV, dh);
prefill attends through ``ops.flash_attention``, decode through
``ops.decode_attention``. Both feed a MoE FFN of routed experts
(``layers.moe_ffn``, whose three expert products run through the
grouped-GEMM kernel) plus shared experts where the config has any. Block
params are stacked on a leading layer axis as in the reference; its
``lax.scan`` over layers is a Python loop here.

Weights: the reference keeps f32 params and casts every matrix, expert
tensor and router to bf16 at each use; the port's loaders keep the bf16
copy once (the norm scales ``ln1``, ``ln2``, ``kv_ln`` and ``ln_f`` stay
f32), which gives the same numbers.

Routing: the full-sequence paths take the exact-length expert capacity
(``route_capacity``; the whole batch's under a mesh) and can record
(``return_route_keep``) or replay (``route_keep``) a prompt's drop
population; decode is dropless. The
latent-page (paged) paths serve the MLA branch only: GQA-MoE is static-
only, as in the reference.

Training: ``loss_fn`` is the reference's, cross-entropy plus 0.01 x the
load-balance loss averaged over layers; the blocks walk per-layer views
of the stacked leaves and, with ``remat``, are recomputed in the
backward, where the expert products differentiate through the grouped
GEMM's dX / dW kernels. It runs on one rank: under a mesh of more than
one rank it raises.

Tensor parallelism (serving, under a mesh installed by
``layers.set_shard_ctx``): each rank holds its slices of the params
(``launch.sharding.param_pspecs``, ``init_params(local=)``). The routed
experts are split over the model axis (expert parallelism): every rank
routes the same tokens with the replicated router and runs its own
experts (``layers.moe_ffn``); the shared experts are column / row
parallel, and one all-reduce sums both parts. The data axes' ranks each
dispatch their own rows at the group capacity (``layers.moe_ffn``'s
groups). olmoe's attention is the dense family's (the rank's heads, KV
heads expanded by ``kv_expand`` where the model axis outgrows them). MLA
is head parallel: wq's whole heads and w_uk / w_uv's heads are the
rank's; the rank's columns of the latent and rope projections are
gathered whole, so every rank normalizes and rotates the one-rank latent
row; its caches and pages hold its even slice of the row's channels
(``cache_width``, the reference's state spec); a prefill attends the
whole rows it computed, a decode step its cache channels, the scores
summed over the model axis (``_cache_attend``). ``prefill`` and
``decode_step`` return the rank's vocabulary columns, the paged
functions the whole vocabulary's. At one rank every collective is the
identity and the code is the one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..kernels import ops
from . import layers as L
from .transformer import _head, _last, _qkv

ATTN_CHUNK_THRESHOLD = 2048     # longer prompts attend in query chunks


def _need_mla(cfg) -> None:
    if cfg.mla is None:
        raise NotImplementedError(
            f"{cfg.name!r}: the latent-page paths serve MLA-MoE only; "
            f"GQA-MoE is static-only (prefill / decode_step)")


# --- params ----------------------------------------------------------------------

def _layer_params(cfg, gen, dev, keep) -> dict:
    """One block's params, the reference's distributions (truncated
    normal, std 1/sqrt(d_in); W_uk / W_uv 1/sqrt(kv_lora_rank)), each
    drawn tensor passed through ``keep(path, t)``."""
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    norm_init, _ = L.make_norm(cfg)

    def normal(name, shape, std):
        t = torch.empty(shape, dtype=L.PARAM_DTYPE, device=dev)
        return keep(("blocks", name),
                    L.trunc_normal_(t, gen, std).to(L.COMPUTE_DTYPE))

    def dense(name, d_in, d_out):
        return normal(name, (d_in, d_out), 1.0 / math.sqrt(d_in))

    def const(name, t):
        return keep(("blocks", name), t)

    def moe():                      # drawn last, after the attention's
        return {k: keep(("blocks", "moe", k), v) for k, v in
                L.init_moe_params(cfg, D, gen, dev).items()}
    if m is None:                   # GQA
        return {"ln1": const("ln1", norm_init(D, dev)),
                "ln2": const("ln2", norm_init(D, dev)),
                "wq": dense("wq", D, cfg.q_dim),
                "wk": dense("wk", D, cfg.kv_dim),
                "wv": dense("wv", D, cfg.kv_dim),
                "wo": dense("wo", cfg.q_dim, D), "moe": moe()}
    r = m.kv_lora_rank
    return {
        "ln1": const("ln1", norm_init(D, dev)),
        "ln2": const("ln2", norm_init(D, dev)),
        "wq": dense("wq", D, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
        "w_dkv": dense("w_dkv", D, r),
        "w_kr": dense("w_kr", D, m.qk_rope_head_dim),
        "kv_ln": const("kv_ln", torch.ones(r, dtype=L.PARAM_DTYPE,
                                           device=dev)),
        "w_uk": normal("w_uk", (H, r, m.qk_nope_head_dim), 1.0 / math.sqrt(r)),
        "w_uv": normal("w_uv", (H, r, m.v_head_dim), 1.0 / math.sqrt(r)),
        "wo": dense("wo", H * m.v_head_dim, D),
        "moe": moe(),
    }


def init_params(cfg, seed: int = 0, device="cuda", local=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` one layer at a time into the stacked tensors.
    ``local(path, t)`` (``launch.sharding.local_init``) keeps a rank's
    slice of each drawn tensor: every rank draws the same stream and
    holds only its slices, which equal the one-rank draw's bit for bit
    (the routed experts' slice is the rank's experts)."""
    dev = resolve_device(device)
    gen = L.seeded_generator(dev, seed)
    D, V, Lc = cfg.d_model, cfg.vocab_size, cfg.num_layers
    norm_init, _ = L.make_norm(cfg)
    keep = local or (lambda path, t: t)

    blocks = L.stack_layers(lambda: _layer_params(cfg, gen, dev, keep), Lc,
                            dev)

    def dense(name, d_in, d_out, std):
        w = torch.empty((d_in, d_out), dtype=L.PARAM_DTYPE, device=dev)
        return keep((name,), L.trunc_normal_(w, gen, std).to(L.COMPUTE_DTYPE))

    return {"embed": dense("embed", V, D, 0.02), "blocks": blocks,
            "ln_f": keep(("ln_f",), norm_init(D, dev)),
            "lm_head": dense("lm_head", D, V, 1.0 / math.sqrt(D))}


def _layer(params, i: int) -> dict:
    def pick(tree):
        return {k: pick(v) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    return pick(params["blocks"])


# --- multi-head latent attention ---------------------------------------------------

def _rope(cfg, positions):
    dim = cfg.head_dim if cfg.mla is None else cfg.mla.qk_rope_head_dim
    return L.rope_cos_sin(positions, dim, cfg.rope_theta)


def _gqa_out(cfg, p, x, attn):
    """GQA output projection and the residual: attn (B, S, heads, dh),
    the rank's heads, whose row-parallel partial sums are summed over the
    model axis."""
    B, S = attn.shape[:2]
    o = attn.reshape(B, S, -1) @ p["wo"]
    return x + L.reduce_rows(o, p["wo"], cfg.q_dim).to(x.dtype)


def _mla_heads(cfg, p) -> int:
    """This rank's MLA heads: wq's whole heads of dn + dr columns, which
    w_uk's and w_uv's head split must match; raises where the model axis
    cuts a head or splits the two differently."""
    m = cfg.mla
    hl = L.whole_heads(cfg, p["wq"].shape[-1], "wq",
                       m.qk_nope_head_dim + m.qk_rope_head_dim)
    if p["w_uk"].shape[0] != hl or (L.tp_size() > 1
                                    and hl * L.tp_size() != cfg.num_heads):
        raise NotImplementedError(
            f"{cfg.name}: {hl} wq heads a rank against w_uk's "
            f"{p['w_uk'].shape[0]}; the rank-local executor runs split "
            f"heads only")
    return hl


def _whole_cols(t, full: int):
    """``t``, a column-parallel product's columns on this rank, gathered
    whole over the model axis (itself where the weight is whole)."""
    return t if t.shape[-1] == full else L.tp_all_gather(t, -1)


def _mla_in(cfg, p, h, rope):
    """Projections of the normed input h (B, S, D): the absorbed query
    q_lat (B, S, heads, r), the rotated rope query (B, S, heads, dr) and
    the latent row [rmsnorm(h W_dkv) | rope(h W_kr)] (B, S, r + dr),
    whole. Under tensor parallelism the heads are the rank's, and the
    rank's latent and rope columns are gathered whole before the norm
    and the rotation (every rank then holds the one-rank row)."""
    m = cfg.mla
    B, S, _ = h.shape
    dn = m.qk_nope_head_dim
    hl = cfg.num_heads if L.tp_size() == 1 else _mla_heads(cfg, p)
    q = (h @ p["wq"]).view(B, S, hl, dn + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :dn], L.rotate(q[..., dn:], *rope)
    c_kv = L.rmsnorm(_whole_cols(h @ p["w_dkv"], m.kv_lora_rank),
                     p["kv_ln"])                               # (B,S,r)
    k_rope = L.rotate(_whole_cols(h @ p["w_kr"], m.qk_rope_head_dim)
                      [:, :, None, :], *rope)                  # (B,S,1,dr)
    latent = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    q_lat = torch.einsum("bshd,hrd->bshr", q_nope, p["w_uk"])
    return q_lat, q_rope, latent


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                           + cfg.mla.qk_rope_head_dim)


def _mla_attend(cfg, q_lat, q_rope, latents, valid=None):
    """Absorbed-score attention over latent rows (B, T, r + dr): scores
    q_lat . c + q_rope . k_rope in bf16, softmax in f32 where ``valid``
    (broadcastable to (B, H, S, T); None: every row), then the
    probabilities times the latents: (B, S, H, r)."""
    r = cfg.mla.kv_lora_rank
    c_all, kr_all = latents[..., :r], latents[..., r:]
    s = (torch.einsum("bshr,btr->bhst", q_lat, c_all)
         + torch.einsum("bshd,btd->bhst", q_rope, kr_all))
    s = s.float() * _mla_scale(cfg)
    if valid is not None:
        s = s.masked_fill(~valid, L.NEG_INF)
    probs = torch.softmax(s, dim=-1).to(c_all.dtype)
    return torch.einsum("bhst,btr->bshr", probs, c_all)


def _cache_attend(cfg, q_lat, q_rope, cache, valid=None):
    """``_mla_attend`` of the rank's heads over cached latent rows (B, T,
    w). Where the cache holds the whole row (w = r + dr) the rank attends
    alone. Where it holds the rank's w channels of it (``cache_width``),
    every rank gathers every head's [q_lat | q_rope] (B, S, H, r + dr),
    scores its channels, sums the scores over the model axis in f32,
    weighs its channels by the probabilities and gathers the weighed
    channels whole: (B, S, heads, r) of the rank's heads."""
    w = cache.shape[-1]
    if w == latent_width(cfg):
        return _mla_attend(cfg, q_lat, q_rope, cache, valid)
    r, hl, rank = cfg.mla.kv_lora_rank, q_lat.shape[2], L.tp_rank()
    q = L.tp_all_gather(torch.cat([q_lat, q_rope], dim=-1), 2)
    s = torch.einsum("bshc,btc->bhst", q[..., rank * w:(rank + 1) * w],
                     cache).float()
    s = L.tp_all_reduce(s) * _mla_scale(cfg)
    if valid is not None:
        s = s.masked_fill(~valid, L.NEG_INF)
    probs = torch.softmax(s, dim=-1).to(cache.dtype)
    out = L.tp_all_gather(torch.einsum("bhst,btc->bshc", probs, cache), -1)
    return out[:, :, rank * hl:(rank + 1) * hl, :r]


def _mla_out(cfg, p, x, out_lat):
    """Absorbed value/output projections and the residual; wo's
    row-parallel partial sums summed over the model axis."""
    B, S, H, _ = out_lat.shape
    attn = torch.einsum("bshr,hrd->bshd", out_lat, p["w_uv"])
    o = attn.reshape(B, S, H * cfg.mla.v_head_dim) @ p["wo"]
    return x + L.reduce_rows(o, p["wo"], cfg.num_heads
                             * cfg.mla.v_head_dim).to(x.dtype)


def _causal_attend(cfg, q_lat, q_rope, latents):
    """Causal attention of a whole sequence over its own latents, in
    query chunks past ATTN_CHUNK_THRESHOLD (never the full (S, S))."""
    S = q_lat.shape[1]
    qc = S if S <= ATTN_CHUNK_THRESHOLD else math.gcd(S, 1024)
    kj = torch.arange(S, device=q_lat.device)[None, :]
    outs = []
    for q0 in range(0, S, qc):
        qi = (q0 + torch.arange(qc, device=q_lat.device))[:, None]
        outs.append(_mla_attend(cfg, q_lat[:, q0:q0 + qc],
                                q_rope[:, q0:q0 + qc], latents, kj <= qi))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


# --- MoE tail --------------------------------------------------------------------

def _moe_ffn_tail(cfg, p, y, dims, route_keep=None, return_keep=False,
                  return_aux=False):
    """Second half of every block: norm -> routed experts (+ shared
    experts) -> residual. ``route_keep`` (B, S, k) replays a drop
    population. Returns (y, the realized keep mask (B, S, k) where
    ``return_keep`` else None, the load-balance loss where ``return_aux``
    else None).

    Under tensor parallelism the routed experts' output is the rank's
    experts' part and the shared experts' (column-parallel gate and up,
    row-parallel down) the rank's partial sum: one all-reduce over the
    model axis sums both (a part left whole on every rank joins after
    the sum)."""
    _, norm = L.make_norm(cfg)
    B, S, D = y.shape
    h2 = norm(y, p["ln2"]).to(L.COMPUTE_DTYPE).reshape(B * S, D)
    mp = p["moe"]
    out = L.moe_ffn(h2, mp, dims, keep_override=None if route_keep is None
                    else route_keep.reshape(B * S, -1),
                    return_keep=return_keep, return_aux=return_aux)
    out = out if isinstance(out, tuple) else (out,)
    ff = out[0]
    split = mp["w_gate"].shape[0] != cfg.moe.num_experts
    if cfg.moe.num_shared_experts:
        shared = L.swiglu(h2, mp["shared_gate"], mp["shared_up"],
                          mp["shared_down"])
        whole = mp["shared_down"].shape[0] == cfg.moe.d_ff_expert \
            * cfg.moe.num_shared_experts
        if split and whole:
            ff, split = L.tp_all_reduce(ff), False
        elif L.tp_size() > 1 and not (split or whole):
            shared = L.tp_all_reduce(shared)
        ff = ff + shared
    if split:
        ff = L.tp_all_reduce(ff)
    res = y + ff.reshape(B, S, D).to(y.dtype)
    keep = out[1].reshape(B, S, -1) if return_keep else None
    return res, keep, out[-1] if return_aux else None


# --- full sequence -------------------------------------------------------------------

def _block(cfg, p, x, rope, dims, route_keep, return_keep, return_aux,
           e: int = 1):
    """One block over whole sequences, causal: (y, its cache rows — MLA:
    the rank's channels of the latents (B, S, w) (``cache_width``); GQA:
    (k, v) each (B, S, cache heads, dh), KV heads expanded ``e`` times —,
    keep or None, aux or None)."""
    _, norm = L.make_norm(cfg)
    if cfg.mla is None:
        q, k, v = _qkv(cfg, p, x, rope, e)
        y = _gqa_out(cfg, p, x, ops.flash_attention(q, k, v, causal=True))
        kv = (k, v)
    else:
        h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
        q_lat, q_rope, latent = _mla_in(cfg, p, h, rope)
        y = _mla_out(cfg, p, x, _causal_attend(cfg, q_lat, q_rope, latent))
        kv = _own_channels(cfg, latent)
    y, keep, aux = _moe_ffn_tail(cfg, p, y, dims, route_keep=route_keep,
                                 return_keep=return_keep,
                                 return_aux=return_aux)
    return y, kv, keep, aux


def _trunk(cfg, params, batch, *, route_capacity=None, route_keep=None,
           return_kv=False, return_keep=False, return_aux=False,
           remat=False, e: int = 1):
    """The blocks over whole sequences, causal, each block's params a
    view of the stacked leaves (``layers.layer_views``: one gradient a
    leaf, not a full-size one a layer). ``remat`` recomputes each block
    in the backward (``layers.checkpointed``); the recomputation routes
    as the first pass did: the same inputs, so the same router product,
    ``topk`` and stable sort. The expert capacity is the whole batch's
    (``layers.global_tokens``: under a mesh the rank holds its rows).
    Returns (hidden (B, S, D), the cache rows or None — MLA: latents (L,
    B, S, w); GQA: (k, v) each (L, B, S, cache heads, dh) —, keeps (L, B,
    S, k) or None, the mean over layers of the load-balance loss or
    None)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope = _rope(cfg, positions)
    dims = L.moe_dims(cfg, L.global_tokens(B * S))
    if route_capacity is not None:
        dims = dataclasses.replace(dims, capacity=route_capacity)
    x = L.embed_tokens(cfg, params, tokens)
    kvs, keeps, auxs = [], [], []
    for i, p in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
        x, kv, keep, aux = L.checkpointed(
            _block, cfg, p, x, rope, dims,
            None if route_keep is None else route_keep[i], return_keep,
            return_aux, e, remat=remat)
        keeps.append(keep)
        auxs.append(aux)
        if return_kv:
            kvs.append(kv)
    if return_kv:
        kvs = torch.stack(kvs) if cfg.mla is not None else \
            tuple(torch.stack(t) for t in zip(*kvs))
    return (x, kvs if return_kv else None,
            torch.stack(keeps) if return_keep else None,
            torch.stack(auxs).mean() if return_aux else None)


def forward(cfg, params, batch, *, remat=False, return_aux=False,
            route_capacity=None, route_keep=None, return_route_keep=False):
    """Logits (B, S, V) f32 for batch["tokens"] (B, S). ``remat``
    recomputes each block in the backward; ``return_aux`` also returns
    the load-balance loss averaged over layers (the reference's ``aux``).
    ``route_capacity`` overrides the expert-capacity ceiling (serving
    passes the exact-length one of a padded prompt); ``route_keep`` (L,
    B, S, k) replays a recorded drop population; ``return_route_keep``
    also returns the realized (L, B, S, k) one. Extra outputs in the
    reference's order: (logits, aux, keeps). Under tensor parallelism the
    logits are the rank's vocabulary columns and GQA's KV heads are
    expanded as serving expands them (``serve_kv_expand``)."""
    x, _, keeps, aux = _trunk(cfg, params, batch,
                              route_capacity=route_capacity,
                              route_keep=route_keep,
                              return_keep=return_route_keep,
                              return_aux=return_aux, remat=remat,
                              e=L.serve_kv_expand(cfg, L.tp_size()))
    out = (_head(cfg, params, x), *((aux,) if return_aux else ()),
           *((keeps,) if return_route_keep else ()))
    return out if len(out) > 1 else out[0]


def loss_fn(cfg, params, batch, *, remat=True, aux_coef=0.01):
    """The reference's MoE training loss: mean next-token cross-entropy
    (with the z-loss) of batch["tokens"] against batch["labels"] (B, S),
    plus ``aux_coef`` x the load-balance loss averaged over layers. One
    rank's: under a mesh of more than one rank it raises
    (``layers.single_rank_family``)."""
    L.single_rank_family(cfg)
    logits, aux = forward(cfg, params, batch, remat=remat, return_aux=True)
    return torch.mean(L.softmax_xent(logits, batch["labels"])) \
        + aux_coef * aux


# --- static decode -------------------------------------------------------------------

@dataclasses.dataclass
class MoEDecodeState:
    kv: torch.Tensor       # MLA: (L, B, T, r + dr) latent rows;
    #                        GQA: stacked K/V (2, L, B, T, KV, dh)
    pos: int               # next write offset (lockstep over the batch)


def latent_width(cfg) -> int:
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


def cache_width(cfg) -> int:
    """The latent channels a rank's cache and pages hold: under tensor
    parallelism its even slice of the row's r + dr (the state spec splits
    the last dim over the model axis where it divides), else the whole
    row. Rank i holds channels i w .. (i + 1) w - 1, so the slices
    gathered in rank order are one rank's row."""
    w, tp = latent_width(cfg), L.tp_size()
    return w // tp if w % tp == 0 and w >= tp else w


def _own_channels(cfg, latent):
    """This rank's channels (``cache_width``) of whole latent rows."""
    w = cache_width(cfg)
    if w == latent.shape[-1]:
        return latent
    return latent[..., L.tp_rank() * w:(L.tp_rank() + 1) * w]


def _cache_shape(cfg, batch_size: int, cache_len: int, e: int) -> tuple:
    if cfg.mla is not None:
        return (cfg.num_layers, batch_size, cache_len, cache_width(cfg))
    return (2, cfg.num_layers, batch_size, cache_len,
            L.cache_head_count(cfg, e), cfg.head_dim)


def init_decode_state(cfg, batch_size: int, cache_len: int,
                      dtype=L.COMPUTE_DTYPE, device="cuda",
                      kv_expand: int = 1) -> MoEDecodeState:
    """An empty cache of ``cache_len`` positions, on the card unless
    ``device`` says otherwise: under an installed mesh the rank's share
    (its latent channels, or its cache heads of the KV heads stored
    ``kv_expand`` times), the whole cache without one."""
    return MoEDecodeState(kv=torch.zeros(
        _cache_shape(cfg, batch_size, cache_len, kv_expand), dtype=dtype,
        device=resolve_device(device)), pos=0)


def prefill(cfg, params, batch, cache_len: int, kv_expand: int = 1):
    """Run the full prompt, keep its cache rows (the rank's latent
    channels, or GQA K/V with each KV head stored ``kv_expand`` times) in
    a cache of ``cache_len`` positions, return the last position's
    logits (B, V) (the rank's vocabulary columns under a mesh) and the
    state."""
    B, S = batch["tokens"].shape
    x, kv, _, _ = _trunk(cfg, params, batch, return_kv=True, e=kv_expand)
    logits = _head(cfg, params, x[:, -1:])[:, 0]
    if cfg.mla is not None:
        kv = torch.nn.functional.pad(kv.to(L.COMPUTE_DTYPE),
                                     (0, 0, 0, cache_len - S))
    else:
        kv = torch.nn.functional.pad(torch.stack(kv).to(L.COMPUTE_DTYPE),
                                     (0, 0, 0, 0, 0, cache_len - S))
    return logits, MoEDecodeState(kv=kv, pos=S)


def decode_step(cfg, params, state: MoEDecodeState, tokens):
    """One token for the whole batch, tokens (B,): writes each layer's
    new cache row at ``state.pos`` in place and attends the cache prefix
    [0, pos] (the reference's ``kj <= pos`` mask; GQA through
    ``ops.decode_attention`` with ``lengths = pos + 1``, filled on the
    device; MLA through ``_cache_attend``). Dropless routing: the batch
    holds independent requests. Returns (logits (B, V), the rank's
    vocabulary columns under a mesh, state)."""
    _, norm = L.make_norm(cfg)
    B = tokens.shape[0]
    pos = state.pos
    dev = tokens.device
    rope = _rope(cfg, torch.full((B, 1), pos, device=dev))
    lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    dims = L.moe_dims_dropless(cfg, L.global_tokens(B))
    e = 1 if cfg.mla is not None else L.kv_expansion(cfg, state.kv.shape[4])
    x = L.embed_tokens(cfg, params, tokens[:, None])
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        if cfg.mla is None:
            q, k, v = _qkv(cfg, p, x, rope, e)
            ck, cv = state.kv[0, i], state.kv[1, i]
            ck[:, pos] = k[:, 0].to(ck.dtype)
            cv[:, pos] = v[:, 0].to(cv.dtype)
            attn = ops.decode_attention(q[:, 0], ck, cv, lengths)
            y = _gqa_out(cfg, p, x, attn[:, None])
        else:
            h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
            q_lat, q_rope, latent = _mla_in(cfg, p, h, rope)
            state.kv[i, :, pos] = _own_channels(cfg, latent)[:, 0].to(
                state.kv.dtype)
            cache = state.kv[i, :, :pos + 1].to(L.COMPUTE_DTYPE)
            y = _mla_out(cfg, p, x, _cache_attend(cfg, q_lat, q_rope, cache))
        x = _moe_ffn_tail(cfg, p, y, dims)[0]
    state.pos = pos + 1
    return _head(cfg, params, x)[:, 0], state


# --- paged latent decode (continuous batching) ------------------------------------
# Pages pool the latent rows: a page is a (page, w) slab per layer, w the
# rank's channels of the r + dr row (``cache_width``), not per-head K/V,
# so cache bytes track live tokens at latent width.


@dataclasses.dataclass
class MoEPagedState:
    kv_pages: torch.Tensor  # (L, P, page, w); page 0 = trash page


def init_paged_decode_state(cfg, num_pages: int, page_size: int,
                            dtype=L.COMPUTE_DTYPE, device="cuda"
                            ) -> MoEPagedState:
    """Latent page pools; under an installed mesh the rank's channels."""
    _need_mla(cfg)
    return MoEPagedState(kv_pages=torch.zeros(
        (cfg.num_layers, num_pages, page_size, cache_width(cfg)),
        dtype=dtype, device=resolve_device(device)))


def paged_prefill(cfg, params, batch, lengths, *, route_capacity=None,
                  route_keep=None):
    """Forward the (padded) prompts; return each sequence's last-live-
    token logits (B, V) (the whole vocabulary's: the engine samples
    them), the per-layer latents (L, B, S, w) (the rank's channels) for
    the page scatter, and the realized route keeps (L, B, S, k).

    Causality keeps pads from touching live positions, and capacity is
    claimed in token order, so trailing pads never displace a live token;
    ``route_capacity`` is the exact-length ceiling of the live tokens and
    ``route_keep`` replays a recorded drop population (re-prefill after
    preemption)."""
    _need_mla(cfg)
    x, kv, keeps, _ = _trunk(cfg, params, batch,
                             route_capacity=route_capacity,
                             route_keep=route_keep, return_kv=True,
                             return_keep=True)
    return (_sampled_logits(cfg, params, _last(x, lengths))[:, 0],
            kv.to(L.COMPUTE_DTYPE), keeps)


def _sampled_logits(cfg, params, x):
    """The head's logits of x for a sampler: the whole vocabulary on
    every rank."""
    return L.whole_vocab(_head(cfg, params, x), cfg.vocab_size)


def write_prefill_pages(cfg, state: MoEPagedState, latents, page_ids
                        ) -> None:
    """Scatter one prefilled request's latents (L, S, w), S a page
    multiple, into its pages in place; page_ids (S/page,) with dead
    entries on the trash page."""
    Lc, _, page, width = state.kv_pages.shape
    state.kv_pages[:, page_ids.long()] = latents.reshape(
        Lc, -1, page, width).to(state.kv_pages.dtype)


def _mla_paged_block(cfg, p, x, rope, pages, page_table, page_ids, offsets,
                     pos, dims):
    """One MLA + MoE block over this layer's latent pages (P, page, w),
    S == 1: the new latent row (the rank's channels) is written at
    (page_ids, offsets) in place, then every slot attends its table's
    rows at positions <= its ``pos`` (row j of the gathered table holds
    position j)."""
    _, norm = L.make_norm(cfg)
    B = x.shape[0]
    h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
    q_lat, q_rope, latent = _mla_in(cfg, p, h, rope)
    pages[page_ids.long(), offsets.long()] = \
        _own_channels(cfg, latent)[:, 0].to(pages.dtype)
    g = pages[page_table.long()]                    # (B, M, page, w)
    T = g.shape[1] * g.shape[2]
    g = g.reshape(B, T, -1).to(L.COMPUTE_DTYPE)
    valid = (torch.arange(T, device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    y = _mla_out(cfg, p, x, _cache_attend(cfg, q_lat, q_rope, g, valid))
    return _moe_ffn_tail(cfg, p, y, dims)[0]


def paged_decode_step(cfg, params, state: MoEPagedState, tokens,
                      page_table, lengths, active):
    """One token per slot against the latent pages; returns logits (B, V)
    (the whole vocabulary's) and appends each active slot's latent rows
    in place. tokens (B,); page_table (B, M) int32; lengths (B,) live
    context; active (B,) bool — inactive slots write to the trash page
    and attend one masked entry. The caller advances lengths."""
    _need_mla(cfg)
    B = tokens.shape[0]
    page = state.kv_pages.shape[2]
    active = active.to(torch.bool)
    pos = torch.where(active, lengths.to(torch.int32), 0)
    x = L.embed_tokens(cfg, params, tokens[:, None])
    slot = (pos // page)[:, None].long()
    page_ids = torch.where(active, torch.gather(page_table, 1, slot)[:, 0], 0)
    offsets = torch.where(active, pos % page, 0)
    rope = _rope(cfg, pos[:, None])
    # dropless: slots are independent requests, so batch composition
    # must never cause an expert drop
    dims = L.moe_dims_dropless(cfg, B)
    for i in range(cfg.num_layers):
        x = _mla_paged_block(cfg, _layer(params, i), x, rope,
                             state.kv_pages[i], page_table, page_ids,
                             offsets, pos, dims)
    return _sampled_logits(cfg, params, x)[:, 0]


def paged_decode_multi(cfg, params, state: MoEPagedState, pending, lengths,
                       remaining, page_table, mask, h: int, *, hmax: int,
                       teacher=None):
    """Up to ``h`` fused ``paged_decode_step``s with greedy sampling on
    the device (layers.multi_step_decode); the loop tensors advance in
    place. Decode is dropless, so the fused steps record no routes.
    Returns the (hmax, B) tokens."""
    def step(toks, pt, lens, act):
        return paged_decode_step(cfg, params, state, toks, pt, lens, act)
    return L.multi_step_decode(step, hmax, pending, lengths, remaining,
                               page_table, mask, h, teacher)
