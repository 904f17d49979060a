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
(``route_capacity``) and can record (``return_route_keep``) or replay
(``route_keep``) a prompt's drop population; decode is dropless. The
latent-page (paged) paths serve the MLA branch only: GQA-MoE is static-
only, as in the reference.

Training: ``loss_fn`` is the reference's, cross-entropy plus 0.01 x the
load-balance loss averaged over layers; the blocks walk per-layer views
of the stacked leaves and, with ``remat``, are recomputed in the
backward, where the expert products differentiate through the grouped
GEMM's dX / dW kernels.
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

def _layer_params(cfg, gen, dev) -> dict:
    """One block's params, the reference's distributions (truncated
    normal, std 1/sqrt(d_in); W_uk / W_uv 1/sqrt(kv_lora_rank))."""
    m, D, H = cfg.mla, cfg.d_model, cfg.num_heads
    norm_init, _ = L.make_norm(cfg)

    def normal(shape, std):
        t = torch.empty(shape, dtype=L.PARAM_DTYPE, device=dev)
        return L.trunc_normal_(t, gen, std).to(L.COMPUTE_DTYPE)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    if m is None:                   # GQA
        return {"ln1": norm_init(D, dev), "ln2": norm_init(D, dev),
                "wq": dense(D, cfg.q_dim), "wk": dense(D, cfg.kv_dim),
                "wv": dense(D, cfg.kv_dim), "wo": dense(cfg.q_dim, D),
                "moe": L.init_moe_params(cfg, D, gen, dev)}
    r = m.kv_lora_rank
    return {
        "ln1": norm_init(D, dev), "ln2": norm_init(D, dev),
        "wq": dense(D, H * (m.qk_nope_head_dim + m.qk_rope_head_dim)),
        "w_dkv": dense(D, r), "w_kr": dense(D, m.qk_rope_head_dim),
        "kv_ln": torch.ones(r, dtype=L.PARAM_DTYPE, device=dev),
        "w_uk": normal((H, r, m.qk_nope_head_dim), 1.0 / math.sqrt(r)),
        "w_uv": normal((H, r, m.v_head_dim), 1.0 / math.sqrt(r)),
        "wo": dense(H * m.v_head_dim, D),
        "moe": L.init_moe_params(cfg, D, gen, dev),
    }


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights from a ``torch.Generator`` seeded with ``seed``,
    drawn on ``device`` one layer at a time into the stacked tensors."""
    dev = resolve_device(device)
    gen = L.seeded_generator(dev, seed)
    D, V, Lc = cfg.d_model, cfg.vocab_size, cfg.num_layers
    norm_init, _ = L.make_norm(cfg)

    blocks = L.stack_layers(lambda: _layer_params(cfg, gen, dev), Lc, dev)

    def dense(d_in, d_out, std):
        w = torch.empty((d_in, d_out), dtype=L.PARAM_DTYPE, device=dev)
        return L.trunc_normal_(w, gen, std).to(L.COMPUTE_DTYPE)

    return {"embed": dense(V, D, 0.02), "blocks": blocks,
            "ln_f": norm_init(D, dev),
            "lm_head": dense(D, V, 1.0 / math.sqrt(D))}


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
    """GQA output projection and the residual: attn (B, S, H, dh)."""
    B, S = attn.shape[:2]
    return x + (attn.reshape(B, S, cfg.q_dim) @ p["wo"]).to(x.dtype)


def _mla_in(cfg, p, h, rope):
    """Projections of the normed input h (B, S, D): the absorbed query
    q_lat (B, S, H, r), the rotated rope query (B, S, H, dr) and the
    latent row [rmsnorm(h W_dkv) | rope(h W_kr)] (B, S, r + dr)."""
    m = cfg.mla
    B, S, _ = h.shape
    dn = m.qk_nope_head_dim
    q = (h @ p["wq"]).view(B, S, cfg.num_heads, dn + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :dn], L.rotate(q[..., dn:], *rope)
    c_kv = L.rmsnorm(h @ p["w_dkv"], p["kv_ln"])               # (B,S,r)
    k_rope = L.rotate((h @ p["w_kr"])[:, :, None, :], *rope)   # (B,S,1,dr)
    latent = torch.cat([c_kv, k_rope[:, :, 0]], dim=-1)
    q_lat = torch.einsum("bshd,hrd->bshr", q_nope, p["w_uk"])
    return q_lat, q_rope, latent


def _mla_attend(cfg, q_lat, q_rope, latents, valid=None):
    """Absorbed-score attention over latent rows (B, T, r + dr): scores
    q_lat . c + q_rope . k_rope in bf16, softmax in f32 where ``valid``
    (broadcastable to (B, H, S, T); None: every row), then the
    probabilities times the latents: (B, S, H, r)."""
    r = cfg.mla.kv_lora_rank
    c_all, kr_all = latents[..., :r], latents[..., r:]
    scale = 1.0 / math.sqrt(cfg.mla.qk_nope_head_dim
                            + cfg.mla.qk_rope_head_dim)
    s = (torch.einsum("bshr,btr->bhst", q_lat, c_all)
         + torch.einsum("bshd,btd->bhst", q_rope, kr_all))
    s = s.float() * scale
    if valid is not None:
        s = s.masked_fill(~valid, L.NEG_INF)
    probs = torch.softmax(s, dim=-1).to(c_all.dtype)
    return torch.einsum("bhst,btr->bshr", probs, c_all)


def _mla_out(cfg, p, x, out_lat):
    """Absorbed value/output projections and the residual."""
    B, S, H, _ = out_lat.shape
    attn = torch.einsum("bshr,hrd->bshd", out_lat, p["w_uv"])
    return x + (attn.reshape(B, S, H * cfg.mla.v_head_dim)
                @ p["wo"]).to(x.dtype)


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
    else None)."""
    _, norm = L.make_norm(cfg)
    B, S, D = y.shape
    h2 = norm(y, p["ln2"]).to(L.COMPUTE_DTYPE).reshape(B * S, D)
    mp = p["moe"]
    out = L.moe_ffn(h2, mp, dims, keep_override=None if route_keep is None
                    else route_keep.reshape(B * S, -1),
                    return_keep=return_keep, return_aux=return_aux)
    out = out if isinstance(out, tuple) else (out,)
    ff = out[0]
    if cfg.moe.num_shared_experts:
        ff = ff + L.swiglu(h2, mp["shared_gate"], mp["shared_up"],
                           mp["shared_down"])
    res = y + ff.reshape(B, S, D).to(y.dtype)
    keep = out[1].reshape(B, S, -1) if return_keep else None
    return res, keep, out[-1] if return_aux else None


# --- full sequence -------------------------------------------------------------------

def _block(cfg, p, x, rope, dims, route_keep, return_keep, return_aux):
    """One block over whole sequences, causal: (y, its cache rows — MLA:
    latents (B, S, r + dr); GQA: (k, v) each (B, S, KV, dh) —, keep or
    None, aux or None)."""
    _, norm = L.make_norm(cfg)
    if cfg.mla is None:
        q, k, v = _qkv(cfg, p, x, rope)
        y = _gqa_out(cfg, p, x, ops.flash_attention(q, k, v, causal=True))
        kv = (k, v)
    else:
        h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
        q_lat, q_rope, kv = _mla_in(cfg, p, h, rope)
        y = _mla_out(cfg, p, x, _causal_attend(cfg, q_lat, q_rope, kv))
    y, keep, aux = _moe_ffn_tail(cfg, p, y, dims, route_keep=route_keep,
                                 return_keep=return_keep,
                                 return_aux=return_aux)
    return y, kv, keep, aux


def _trunk(cfg, params, batch, *, route_capacity=None, route_keep=None,
           return_kv=False, return_keep=False, return_aux=False,
           remat=False):
    """The blocks over whole sequences, causal, each block's params a
    view of the stacked leaves (``layers.layer_views``: one gradient a
    leaf, not a full-size one a layer). ``remat`` recomputes each block
    in the backward (``layers.checkpointed``); the recomputation routes
    as the first pass did: the same inputs, so the same router product,
    ``topk`` and stable sort. Returns (hidden (B, S, D), the cache rows or
    None — MLA: latents (L, B, S, r + dr); GQA: (k, v) each (L, B, S, KV,
    dh) —, keeps (L, B, S, k) or None, the mean over layers of the
    load-balance loss or None)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    rope = _rope(cfg, positions)
    dims = L.moe_dims(cfg, B * S)
    if route_capacity is not None:
        dims = dataclasses.replace(dims, capacity=route_capacity)
    x = L.embed_tokens(cfg, params, tokens)
    kvs, keeps, auxs = [], [], []
    for i, p in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
        x, kv, keep, aux = L.checkpointed(
            _block, cfg, p, x, rope, dims,
            None if route_keep is None else route_keep[i], return_keep,
            return_aux, remat=remat)
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
    reference's order: (logits, aux, keeps)."""
    x, _, keeps, aux = _trunk(cfg, params, batch,
                              route_capacity=route_capacity,
                              route_keep=route_keep,
                              return_keep=return_route_keep,
                              return_aux=return_aux, remat=remat)
    out = (_head(cfg, params, x), *((aux,) if return_aux else ()),
           *((keeps,) if return_route_keep else ()))
    return out if len(out) > 1 else out[0]


def loss_fn(cfg, params, batch, *, remat=True, aux_coef=0.01):
    """The reference's MoE training loss: mean next-token cross-entropy
    (with the z-loss) of batch["tokens"] against batch["labels"] (B, S),
    plus ``aux_coef`` x the load-balance loss averaged over layers."""
    logits, aux = forward(cfg, params, batch, remat=remat, return_aux=True)
    return torch.mean(L.softmax_xent(logits, batch["labels"])) \
        + aux_coef * aux


# --- static decode -------------------------------------------------------------------

@dataclasses.dataclass
class MoEDecodeState:
    kv: torch.Tensor       # MLA: (L, B, T, r + dr) latent rows;
    #                        GQA: stacked K/V (2, L, B, T, KV, dh)
    pos: int               # next write offset (lockstep over the batch)


def _cache_shape(cfg, batch_size: int, cache_len: int) -> tuple:
    if cfg.mla is not None:
        return (cfg.num_layers, batch_size, cache_len, latent_width(cfg))
    return (2, cfg.num_layers, batch_size, cache_len, cfg.num_kv_heads,
            cfg.head_dim)


def init_decode_state(cfg, batch_size: int, cache_len: int,
                      dtype=L.COMPUTE_DTYPE, device="cuda",
                      kv_expand: int = 1) -> MoEDecodeState:
    assert kv_expand == 1, "olmoe KV=16 divides tp; MLA caches latents"
    return MoEDecodeState(kv=torch.zeros(
        _cache_shape(cfg, batch_size, cache_len), dtype=dtype,
        device=resolve_device(device)), pos=0)


def prefill(cfg, params, batch, cache_len: int, kv_expand: int = 1):
    """Run the full prompt, keep its cache rows (latents, or GQA K/V) in a
    cache of ``cache_len`` positions, return the last position's logits
    (B, V) and the state (``kv_expand`` must be 1, as in the
    reference)."""
    assert kv_expand == 1, "olmoe KV=16 divides tp; MLA caches latents"
    B, S = batch["tokens"].shape
    x, kv, _, _ = _trunk(cfg, params, batch, return_kv=True)
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
    device). Dropless routing: the batch holds independent requests.
    Returns (logits (B, V), state)."""
    _, norm = L.make_norm(cfg)
    B = tokens.shape[0]
    pos = state.pos
    dev = tokens.device
    rope = _rope(cfg, torch.full((B, 1), pos, device=dev))
    lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    dims = L.moe_dims_dropless(cfg, B)
    x = L.embed_tokens(cfg, params, tokens[:, None])
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        if cfg.mla is None:
            q, k, v = _qkv(cfg, p, x, rope)
            ck, cv = state.kv[0, i], state.kv[1, i]
            ck[:, pos] = k[:, 0].to(ck.dtype)
            cv[:, pos] = v[:, 0].to(cv.dtype)
            attn = ops.decode_attention(q[:, 0], ck, cv, lengths)
            y = _gqa_out(cfg, p, x, attn[:, None])
        else:
            h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
            q_lat, q_rope, latent = _mla_in(cfg, p, h, rope)
            state.kv[i, :, pos] = latent[:, 0].to(state.kv.dtype)
            cache = state.kv[i, :, :pos + 1].to(L.COMPUTE_DTYPE)
            y = _mla_out(cfg, p, x, _mla_attend(cfg, q_lat, q_rope, cache))
        x = _moe_ffn_tail(cfg, p, y, dims)[0]
    state.pos = pos + 1
    return _head(cfg, params, x)[:, 0], state


# --- paged latent decode (continuous batching) ------------------------------------
# Pages pool the latent rows: a page is a (page, r + dr) slab per layer,
# not per-head K/V, so cache bytes track live tokens at latent width.


def latent_width(cfg) -> int:
    return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim


@dataclasses.dataclass
class MoEPagedState:
    kv_pages: torch.Tensor  # (L, P, page, r + dr); page 0 = trash page


def init_paged_decode_state(cfg, num_pages: int, page_size: int,
                            dtype=L.COMPUTE_DTYPE, device="cuda"
                            ) -> MoEPagedState:
    _need_mla(cfg)
    return MoEPagedState(kv_pages=torch.zeros(
        (cfg.num_layers, num_pages, page_size, latent_width(cfg)),
        dtype=dtype, device=resolve_device(device)))


def paged_prefill(cfg, params, batch, lengths, *, route_capacity=None,
                  route_keep=None):
    """Forward the (padded) prompts; return each sequence's last-live-
    token logits (B, V), the per-layer latents (L, B, S, r + dr) for the
    page scatter, and the realized route keeps (L, B, S, k).

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
    return (_head(cfg, params, _last(x, lengths))[:, 0],
            kv.to(L.COMPUTE_DTYPE), keeps)


def write_prefill_pages(cfg, state: MoEPagedState, latents, page_ids
                        ) -> None:
    """Scatter one prefilled request's latents (L, S, r + dr), S a page
    multiple, into its pages in place; page_ids (S/page,) with dead
    entries on the trash page."""
    Lc, _, page, width = state.kv_pages.shape
    state.kv_pages[:, page_ids.long()] = latents.reshape(
        Lc, -1, page, width).to(state.kv_pages.dtype)


def _mla_paged_block(cfg, p, x, rope, pages, page_table, page_ids, offsets,
                     pos, dims):
    """One MLA + MoE block over this layer's latent pages (P, page, r +
    dr), S == 1: the new latent row is written at (page_ids, offsets) in
    place, then every slot attends its table's rows at positions <= its
    ``pos`` (row j of the gathered table holds position j)."""
    _, norm = L.make_norm(cfg)
    B = x.shape[0]
    h = norm(x, p["ln1"]).to(L.COMPUTE_DTYPE)
    q_lat, q_rope, latent = _mla_in(cfg, p, h, rope)
    pages[page_ids.long(), offsets.long()] = latent[:, 0].to(pages.dtype)
    g = pages[page_table.long()]                    # (B, M, page, r + dr)
    T = g.shape[1] * g.shape[2]
    g = g.reshape(B, T, -1).to(L.COMPUTE_DTYPE)
    valid = (torch.arange(T, device=x.device)[None, :]
             <= pos[:, None])[:, None, None, :]
    y = _mla_out(cfg, p, x, _mla_attend(cfg, q_lat, q_rope, g, valid))
    return _moe_ffn_tail(cfg, p, y, dims)[0]


def paged_decode_step(cfg, params, state: MoEPagedState, tokens,
                      page_table, lengths, active):
    """One token per slot against the latent pages; returns logits (B, V)
    and appends each active slot's latent rows in place. tokens (B,);
    page_table (B, M) int32; lengths (B,) live context; active (B,) bool
    — inactive slots write to the trash page and attend one masked entry.
    The caller advances lengths."""
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
    return _head(cfg, params, x)[:, 0]


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
