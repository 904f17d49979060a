"""Dense decoder-only transformer (codeqwen1.5-7b, olmo-1b) and the
qwen2-vl-7b backbone (M-RoPE and patch-embedding injection; the vision
frontend is a stub, as in the reference), in PyTorch.

Counterpart of ``repro.models.transformer``. Block
params are stacked on a leading layer axis as in the reference; the
reference's ``lax.scan`` over layers is a Python loop here, with each
layer's KV pool a view ``k_pages[l]`` updated in place.

Weights: the reference keeps f32 params and casts each matrix to bf16 at
every use. The port's loaders (``init_params``, ``convert``) cast once
and keep only the bf16 copy of matrices, embeddings and biases, which
gives the same numbers and halves the weight bytes every step reads; the
norm scales stay f32 (the norms compute in f32). Training keeps f32
master weights (``convert.master_params``, ``convert.params_from_jax
(master=True)``) and casts them once a step (``convert.compute_view``),
so gradients land in f32 and the forward is the same code.

Training: ``loss_fn`` is the reference's (mean cross-entropy with its
z-loss); ``forward(remat=True)`` recomputes each block in the backward,
and the flash attention of the forward differentiates through its
backward kernels on the card.

Attention: causal attention over a whole sequence (``forward``, the
static and paged prefill) goes through ``ops.flash_attention``; the
static decode's one query over its dense cache through
``ops.decode_attention``, and paged decode through
``ops.paged_decode_attention``. The prefix-shared prefill keeps the
plain masked attention, as the reference does: its mask (ragged prefix |
causal suffix) is not the flash kernel's.

KV expansion (``kv_expand`` e): the serving caches may store each KV
head e times (``layers.serve_kv_expand``), so that their head axis
divides the model axis of a mesh; q head h then reads expanded head
h // (G/e). ``prefill`` and ``init_decode_state`` take e, and every
decode reads it back from its cache's head count.

Tensor parallelism (the dense and vlm families, under a mesh installed
by ``layers.set_shard_ctx``): each rank holds its slices of the params
(``launch.sharding.param_pspecs``) and runs Megatron style. The
column-parallel wq/wk/wv/w_gate/w_up give the rank's heads and FFN
columns, the row-parallel wo/w_down give partial sums that
``layers.reduce_from_tp`` sums over the model axis, the vocabulary-parallel
embedding looks up its own rows (zeros elsewhere) and sums them, and the
head yields the logits of the rank's vocabulary columns: ``prefill`` and
``decode_step`` return them so (the reference's ``_logits_spec``), the
paged functions, whose logits the engine samples, gather them. Every local size comes from the local weights (and the
cache's head count), never from the config unchanged; a split that cuts
a head raises. qwen2-vl's column-parallel patch_proj gives the rank's
D columns of the patch embeddings, gathered whole (``gather_whole``)
before they join the replicated stream; M-RoPE turns each of the rank's
heads as one rank does. Where wk/wv are cut within a head (fewer KV heads than
model ranks), the rank gathers them and keeps its expanded heads. The
collectives are ``layers``' differentiable ones (the replicated input of
every column-parallel product through ``copy_to_tp``, the gather through
``gather_from_tp``), so training differentiates through them; with grad
mode off they are serving's. Training expands the KV heads as serving
does and takes the vocabulary-parallel loss. A leaf FSDP splits over
the data axis (a train step's streamed groups) is gathered where it is
used (``layers.fsdp_leaf``): a block's inside the block, so a remat
recompute gathers it again. At one rank every collective is the identity
and the code is the one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..kernels import ops
from . import layers as L

# params kept in f32 (the norm scales, MLA's kv_ln, whisper's layernorm
# scales and biases, which the reference adds in f32, and griffin's norm
# scales ln / ln_mlp and RG-LRU decay lam, which the reference passes
# uncast); every other leaf is stored in bf16
F32_PARAMS = frozenset({"ln1", "ln2", "ln_f", "kv_ln", "ln1b", "ln2b",
                        "ln_x", "ln_xb", "enc_ln", "enc_lnb", "dec_ln",
                        "dec_lnb", "ln", "ln_mlp", "lam"})


# --- params ----------------------------------------------------------------------

def init_params(cfg, seed: int = 0, device="cuda", local=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``:
    the reference's distributions (truncated normal, std 1/sqrt(d_in)
    for matrices, 0.02 for the embedding), drawn on ``device``
    (``"meta"``: shapes only, no draw).

    ``local(path, t)`` (``launch.sharding.local_init``) keeps a rank's
    slice of each drawn tensor, ``t`` the whole leaf at ``path`` or one
    layer of a stacked leaf: every rank draws the same stream, one f32
    matrix at a time, and holds only its slices, which equal the slices
    of the one-rank draw bit for bit."""
    dev = resolve_device(device)
    gen = L.seeded_generator(dev, seed)
    D, F, V, Lc = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    Q, KV = cfg.q_dim, cfg.kv_dim
    norm_init, _ = L.make_norm(cfg)
    cd = L.COMPUTE_DTYPE
    keep = local or (lambda path, t: t)

    def matrix(path, d_in, d_out, std=None):
        w = torch.empty((d_in, d_out), dtype=L.PARAM_DTYPE, device=dev)
        L.trunc_normal_(w, gen, std or 1.0 / math.sqrt(d_in))
        return keep(path, w.to(cd))

    def stacked(name, d_in, d_out):
        path = ("blocks", name)
        first = matrix(path, d_in, d_out)   # one f32 layer at a time
        out = torch.empty((Lc, *first.shape), dtype=cd, device=dev)
        out[0] = first
        for i in range(1, Lc):
            out[i] = matrix(path, d_in, d_out)
        return out

    def const(name, t):
        return keep(("blocks", name), t)

    blocks = {
        "ln1": const("ln1", torch.stack([norm_init(D, dev)] * Lc)),
        "ln2": const("ln2", torch.stack([norm_init(D, dev)] * Lc)),
        "wq": stacked("wq", D, Q), "wk": stacked("wk", D, KV),
        "wv": stacked("wv", D, KV), "wo": stacked("wo", Q, D),
        "w_gate": stacked("w_gate", D, F), "w_up": stacked("w_up", D, F),
        "w_down": stacked("w_down", F, D),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", Q), ("bk", KV), ("bv", KV)):
            blocks[name] = const(name, torch.zeros((Lc, n), dtype=cd,
                                                   device=dev))
    params = {"embed": matrix(("embed",), V, D, std=0.02), "blocks": blocks,
              "ln_f": keep(("ln_f",), norm_init(D, dev))}
    if not cfg.tie_embeddings:
        params["lm_head"] = matrix(("lm_head",), D, V)
    if cfg.family == "vlm":
        params["patch_proj"] = matrix(("patch_proj",), D, D)
    return params


def _layer(params, i: int) -> dict:
    return {k: w[i] for k, w in params["blocks"].items()}


# --- block -----------------------------------------------------------------------

def _qkv(cfg, p, x, rope, e: int = 1):
    """Pre-norm, projections, bias and RoPE: q (B, S, heads, dh) and k, v
    in the cache's (B, S, cache heads, dh), each KV head expanded ``e``
    times; under a mesh the rank's heads (``layers.rank_heads``).
    ``rope`` is the forward's (cos, sin) from ``layers.rope_cos_sin``."""
    _, norm = L.make_norm(cfg)
    B, S, _ = x.shape
    one = e == 1 and L.tp_size() == 1
    hl, ce = (cfg.num_heads, cfg.num_kv_heads) if one \
        else L.rank_heads(cfg, p["wq"].shape[-1], e)
    h = L.copy_to_tp(norm(x, p["ln1"]).to(L.COMPUTE_DTYPE))
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if one:                             # one rank, no expansion: as stored
        dh = cfg.head_dim
        return (L.rotate(q.view(B, S, hl, dh), *rope),
                L.rotate(k.view(B, S, ce, dh), *rope), v.view(B, S, ce, dh))
    q = L.rotate(q.view(B, S, hl, cfg.head_dim), *rope)
    k = L.rotate(L.cache_heads(cfg, k, e, ce), *rope)
    return q, k, L.cache_heads(cfg, v, e, ce)


def _finish(cfg, p, x, attn):
    """Output projection, residual, pre-norm SwiGLU FFN, residual."""
    _, norm = L.make_norm(cfg)
    B, S, _ = x.shape
    sharded = L.tp_size() > 1
    o = attn.reshape(B, S, -1) @ p["wo"]
    if sharded:
        o = L.reduce_rows(o, p["wo"], cfg.q_dim)
    y = x + o.to(x.dtype)
    h2 = L.copy_to_tp(norm(y, p["ln2"]).to(L.COMPUTE_DTYPE))
    f = L.swiglu(h2, p["w_gate"], p["w_up"], p["w_down"])
    if sharded:
        f = L.reduce_rows(f, p["w_down"], cfg.d_ff)
    return y + f.to(x.dtype)


# --- embedding / head ---------------------------------------------------------------

def _embed_batch(cfg, params, batch):
    """Embeddings of batch["tokens"]; for the vlm family the first P rows
    become batch["patch_embeds"] (B, P, D) projected through
    ``patch_proj`` in bf16, where the batch carries them (under tensor
    parallelism the rank's D columns of the projection, gathered whole
    before they join the replicated residual stream)."""
    x = L.embed_tokens(cfg, params, batch["tokens"])
    pe = batch.get("patch_embeds")
    if cfg.family == "vlm" and pe is not None:
        w = L.fsdp_leaf(params["patch_proj"], "patch_proj")
        pe = L.copy_to_tp(pe.to(L.COMPUTE_DTYPE)) @ w
        if w.shape[-1] != cfg.d_model:      # column-parallel: a D slice
            pe = L.gather_whole(pe, -1)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _head(cfg, params, x):
    """Final norm and the head: f32 logits of this rank's vocabulary
    columns (all of them at one rank)."""
    _, norm = L.make_norm(cfg)
    h = norm(x, params["ln_f"]).to(L.COMPUTE_DTYPE)
    w = L.fsdp_leaf(params["embed"], "embed").T if cfg.tie_embeddings \
        else L.fsdp_leaf(params["lm_head"], "lm_head")
    return L.head_logits(h, w, cfg.vocab_size)


def _rope(cfg, positions, pos3=None):
    """The rotary (cos, sin) of ``positions`` (B, S); with M-RoPE, of the
    (3, B, S) triple ``pos3``, which defaults to ``positions`` on all
    three rows, as the reference builds it."""
    if cfg.mrope:
        if pos3 is None:
            pos3 = positions[None].expand(3, *positions.shape)
        return L.mrope_cos_sin(pos3, cfg.head_dim, cfg.rope_theta)
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _block(cfg, p, x, rope, e: int = 1):
    """One decoder block over the whole sequence, causal flash attention:
    (y, k, v), k and v in the cache's heads."""
    p = L.fsdp_whole(p, "blocks/", layer=True)
    q, k, v = _qkv(cfg, p, x, rope, e)
    return _finish(cfg, p, x, ops.flash_attention(q, k, v, causal=True)), \
        k, v


def _trunk(cfg, params, batch, return_kv: bool, remat: bool = False,
           e: int = 1):
    """The blocks over the whole sequence with causal flash attention.
    ``batch`` may carry "positions" (B, S), "pos3" (3, B, S) and, for the
    vlm family, "patch_embeds". ``remat`` recomputes each block in the
    backward. Returns (hidden (B, S, D), (k, v) each (L, B, S, cache
    heads, dh), KV heads expanded ``e`` times, or None)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    rope = _rope(cfg, batch.get("positions", torch.arange(
        S, device=tokens.device).expand(B, S)), batch.get("pos3"))
    x = _embed_batch(cfg, params, batch)
    ks, vs = [], []
    for p in L.layer_views(params["blocks"], cfg.num_layers):
        x, k, v = L.checkpointed(_block, cfg, p, x, rope, e, remat=remat)
        if return_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def _last(x, lengths):
    """Row ``lengths[b] - 1`` of each sequence: (B, S, D) -> (B, 1, D)."""
    idx = (lengths.long() - 1)[:, None, None].expand(-1, 1, x.shape[-1])
    return torch.gather(x, 1, idx)


# --- full-sequence forward ---------------------------------------------------------

def forward(cfg, params, batch, *, remat=False):
    """Logits (B, S, V) f32 for batch["tokens"] (B, S); under tensor
    parallelism (B, S, V / tp), this rank's vocabulary columns, with the
    KV heads expanded as serving expands them (``serve_kv_expand``), so
    that every rank's q heads find their whole KV heads."""
    x, _ = _trunk(cfg, params, batch, return_kv=False, remat=remat,
                  e=L.serve_kv_expand(cfg, L.tp_size()))
    return _head(cfg, params, x)


def loss_fn(cfg, params, batch, *, remat=True):
    """Mean next-token cross-entropy (with the z-loss) of batch["tokens"]
    against batch["labels"] (B, S): the reference's training loss. Where
    the head holds a slice of the vocabulary (tensor parallelism: the
    tied ``embed.T`` as well as ``lm_head``), the vocabulary-parallel
    cross-entropy computes the same loss on every rank."""
    logits = forward(cfg, params, batch, remat=remat)
    return L.mean_xent(logits, batch["labels"], cfg.vocab_size)


# --- static decode -------------------------------------------------------------------

@dataclasses.dataclass
class DecodeState:
    k: torch.Tensor        # (L, B, T, KV, dh)
    v: torch.Tensor
    pos: int               # next write offset (lockstep over the batch)


def init_decode_state(cfg, batch_size: int, cache_len: int,
                      dtype=L.COMPUTE_DTYPE, device="cuda",
                      kv_expand: int = 1) -> DecodeState:
    """An empty dense cache of ``cache_len`` positions, each KV head
    stored ``kv_expand`` times, on the card unless ``device`` says
    otherwise: the whole (one-rank) cache, whose slices
    ``launch.sharding.state_pspecs`` names."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch_size, cache_len,
             cfg.num_kv_heads * kv_expand, cfg.head_dim)
    return DecodeState(k=torch.zeros(shape, dtype=dtype, device=dev),
                       v=torch.zeros(shape, dtype=dtype, device=dev), pos=0)


def prefill(cfg, params, batch, cache_len: int, kv_expand: int = 1):
    """Run the full prompt, materialize the dense KV cache (each KV head
    stored ``kv_expand`` times), return the last position's logits (B, V)
    and the DecodeState."""
    B, S = batch["tokens"].shape
    x, (k, v) = _trunk(cfg, params, batch, return_kv=True, e=kv_expand)
    logits = _head(cfg, params, x[:, -1:])[:, 0]
    pad = (0, 0, 0, 0, 0, cache_len - S)        # pad the position axis
    return logits, DecodeState(k=torch.nn.functional.pad(k, pad),
                               v=torch.nn.functional.pad(v, pad), pos=S)


def decode_step(cfg, params, state: DecodeState, tokens):
    """One token for the whole batch, tokens (B,). Writes the new K/V
    into the cache in place and advances ``state.pos``; returns (logits
    (B, V), state). The query attends the cache prefix [0, pos] — the
    reference's ``kj <= pos`` mask — through ``ops.decode_attention``
    with ``lengths = pos + 1``, filled on the device (no host sync)."""
    B = tokens.shape[0]
    pos = state.pos
    dev = tokens.device
    e = L.kv_expansion(cfg, state.k.shape[3])
    rope = _rope(cfg, torch.full((B, 1), pos, device=dev))
    lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    x = L.embed_tokens(cfg, params, tokens[:, None])
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p, x, rope, e)
        state.k[i, :, pos] = k[:, 0]
        state.v[i, :, pos] = v[:, 0]
        attn = ops.decode_attention(q[:, 0], state.k[i], state.v[i], lengths)
        x = _finish(cfg, p, x, attn[:, None])
    state.pos = pos + 1
    return _head(cfg, params, x)[:, 0], state


# --- paged decode (continuous batching) -----------------------------------------


@dataclasses.dataclass
class PagedDecodeState:
    k_pages: torch.Tensor  # (L, KV, P, page, dh); page 0 = trash page
    v_pages: torch.Tensor


def init_paged_decode_state(cfg, num_pages: int, page_size: int,
                            dtype=L.COMPUTE_DTYPE, device="cuda",
                            kv_expand: int = 1) -> PagedDecodeState:
    """Page pools of the cache heads, each KV head stored ``kv_expand``
    times: under an installed mesh this rank's share of them."""
    k, v = L.paged_cache_init(cfg.num_layers, num_pages, page_size,
                              L.cache_head_count(cfg, kv_expand),
                              cfg.head_dim, dtype, device)
    return PagedDecodeState(k_pages=k, v_pages=v)


def _sampled_logits(cfg, params, x):
    """The head's logits of x for a sampler: the whole vocabulary on
    every rank (gathered over its split under a mesh)."""
    return L.whole_vocab(_head(cfg, params, x), cfg.vocab_size)


def paged_prefill(cfg, params, batch, lengths, kv_expand: int = 1):
    """Forward the (padded) prompts; return each sequence's last-live-
    token logits (B, V) plus the per-layer KV (L, B, S, cache heads, dh)
    for the page scatter. Causality keeps pad positions past ``lengths``
    from touching live ones; the head runs on the last live rows only.
    The engine samples the logits: they are the whole vocabulary's."""
    x, kv = _trunk(cfg, params, batch, return_kv=True, e=kv_expand)
    return _sampled_logits(cfg, params, _last(x, lengths))[:, 0], kv


def write_prefill_pages(cfg, state: PagedDecodeState, kv, page_ids) -> None:
    """Scatter one prefilled request's KV into its pages, in place. kv:
    (k, v) each (L, S, KV, dh), S a page multiple; page_ids (S/page,)
    with dead entries pointing at the trash page."""
    k, v = kv
    L.paged_cache_write_prompt(state.k_pages, k, page_ids)
    L.paged_cache_write_prompt(state.v_pages, v, page_ids)


def copy_kv_page(state: PagedDecodeState, src: int, dst: int) -> None:
    """Duplicate one physical page (all layers, K and V) in place — the
    copy-on-write step before a shared page takes a divergence write."""
    state.k_pages[:, :, dst] = state.k_pages[:, :, src]
    state.v_pages[:, :, dst] = state.v_pages[:, :, src]


def paged_prefill_shared(cfg, params, state: PagedDecodeState, batch,
                         lengths, prefix_pages, prefix_len):
    """Prefill only the suffix past a shared prefix already resident in
    the page pool.

    tokens (B, S) hold the suffix (padded past ``lengths``);
    ``prefix_pages`` (B, Mp) are the full pages holding each row's shared
    prefix (dead entries -> trash page) and ``prefix_len`` (B,) its token
    count (a page multiple). The cached prefix KV was RoPE'd at its
    absolute positions, so suffix queries attend it directly while their
    own positions are offset by ``prefix_len``. Returns last-live-suffix-
    token logits plus the suffix KV (L, B, S, KV, dh).
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    page = state.k_pages.shape[3]
    Mp = prefix_pages.shape[1]
    Tp = Mp * page
    KV, dh = state.k_pages.shape[1], cfg.head_dim     # the pool's heads
    e = L.kv_expansion(cfg, KV)
    dev = tokens.device
    prefix_len = prefix_len.long()
    rope = _rope(cfg, prefix_len[:, None] + torch.arange(S, device=dev))
    x = L.embed_tokens(cfg, params, tokens)

    # keys per layer: [gathered prefix (Tp) | suffix (S)]; prefix entries
    # valid below prefix_len, suffix causal
    qi = torch.arange(S, device=dev)[None, :, None]
    kj = torch.arange(Tp + S, device=dev)[None, None, :]
    mask = torch.where(kj < Tp, kj < prefix_len[:, None, None],
                       kj - Tp <= qi)[:, None, None]
    pages = prefix_pages.long()

    def gather(pool):                   # (KV, P, pg, dh) -> (B, Tp, KV, dh)
        return pool[:, pages].reshape(KV, B, Tp, dh).permute(1, 2, 0, 3)

    ks, vs = [], []
    for i in range(cfg.num_layers):
        p = _layer(params, i)
        q, k, v = _qkv(cfg, p, x, rope, e)
        ck = torch.cat([gather(state.k_pages[i]), k], dim=1)
        cv = torch.cat([gather(state.v_pages[i]), v], dim=1)
        x = _finish(cfg, p, x, L.gqa_attention(q, ck, cv, mask=mask))
        ks.append(k)
        vs.append(v)
    last = _sampled_logits(cfg, params, _last(x, lengths))[:, 0]
    return last, (torch.stack(ks), torch.stack(vs))


def _paged_block(cfg, p, x, rope, k_pages, v_pages, page_table,
                 page_ids, offsets, attn_lengths, e: int = 1):
    """One decoder block over a paged cache, S == 1. k/v_pages (KV, P,
    page, dh) are this layer's pool views; the new token is appended at
    (page_ids, offsets) in place before attention reads it."""
    q, k, v = _qkv(cfg, p, x, rope, e)
    L.paged_cache_append(k_pages, k[:, 0], page_ids, offsets)
    L.paged_cache_append(v_pages, v[:, 0], page_ids, offsets)
    attn = ops.paged_decode_attention(q[:, 0], k_pages, v_pages, page_table,
                                      attn_lengths)
    return _finish(cfg, p, x, attn[:, None])


def paged_decode_step(cfg, params, state: PagedDecodeState, tokens,
                      page_table, lengths, active):
    """One token per slot against the paged cache; returns logits (B, V)
    (the whole vocabulary's: the engine samples them) and appends each
    active slot's K/V to the pool in place.

    tokens (B,) int; page_table (B, M) int32; lengths (B,) int32 live
    context per slot; active (B,) bool — inactive slots write to the
    trash page and read zero-length caches. The caller advances lengths.
    """
    page = state.k_pages.shape[3]
    e = L.kv_expansion(cfg, state.k_pages.shape[1])
    lengths = lengths.to(torch.int32)
    active = active.to(torch.bool)
    x = L.embed_tokens(cfg, params, tokens[:, None])
    slot = (lengths // page)[:, None].long()
    page_ids = torch.gather(page_table, 1, slot)[:, 0]
    page_ids = torch.where(active, page_ids, 0)              # trash page
    offsets = torch.where(active, lengths % page, 0)
    attn_lengths = torch.where(active, lengths + 1, 0)       # incl. new token
    rope = _rope(cfg, lengths[:, None])
    for i in range(cfg.num_layers):
        x = _paged_block(cfg, _layer(params, i), x, rope,
                         state.k_pages[i], state.v_pages[i], page_table,
                         page_ids, offsets, attn_lengths, e)
    return _sampled_logits(cfg, params, x)[:, 0]


def paged_decode_multi(cfg, params, state: PagedDecodeState, pending,
                       lengths, remaining, page_table, mask, h: int, *,
                       hmax: int, teacher=None):
    """Up to ``h`` fused ``paged_decode_step``s with greedy sampling on
    the device (layers.multi_step_decode); the loop tensors advance in
    place. The engine clamps ``h`` at page boundaries, so the page table
    is constant for the whole run. Returns the (hmax, B) tokens."""
    def step(toks, pt, lens, act):
        return paged_decode_step(cfg, params, state, toks, pt, lens, act)
    return L.multi_step_decode(step, hmax, pending, lengths, remaining,
                               page_table, mask, h, teacher)
