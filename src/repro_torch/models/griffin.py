"""RecurrentGemma / Griffin (arXiv:2402.19427), hybrid RG-LRU + local
sliding-window attention, block pattern (rec, rec, attn), in PyTorch.

Counterpart of ``repro.models.griffin``, serving and the training loss
(``loss_fn``; ``forward`` writes no state in place). Every layer is a
temporal mix (the RG-LRU recurrent branch or windowed MQA) plus a gated
MLP, both with residuals.
Layers group into super-blocks of one pattern period (rec, rec, attn); a
tail of rec-only layers covers num_layers % 3 (38 = 12 x 3 + 2). The
reference's ``lax.scan`` over super-blocks is a Python loop here; the
RG-LRU recurrence stays a loop over time, as its ``lax.scan`` is, and the
attention is plain torch (the reference's is jnp: no Pallas site).

Decode state is O(window): a conv shift register and the LRU hidden per
rec layer, and per attn layer a ring of ``window`` KV slots (static
path) or a page-granular window ring in a shared page pool (serving
path). ``decode_step`` and ``paged_decode_step`` update their state's
tensors in place (``copy_``), so a CUDA graph of the step
(``runtime.DecodeGraph``) holds their addresses.

Numerics copied from the reference: ``lam`` and the norm scales ``ln``,
``ln_mlp`` stay f32 (the converter keeps them so; the reference passes
them uncast), ``ln_f`` is cast to bf16 at use; the hidden ``h`` is f32
between calls and the conv register bf16; ``length`` gates padded
prompts (pad positions leave conv and h untouched); prefill above
``ATTN_CHUNK_THRESHOLD`` tokens takes the chunked windowed attention; an
inactive serving slot freezes its recurrent state.

Tensor parallelism (under a mesh installed by ``layers.set_shard_ctx``;
each rank holds its slices of the params by the reference's rules,
``launch.sharding.param_pspecs``): ``w_x`` and ``w_branch`` are
column-parallel, so the branch, the causal conv (``conv_w``, ``conv_b``)
and the RG-LRU (``lam``, ``b_i``, ``b_r``, its hidden) run on the rank's
channels; the gates read the whole conv output (gathered), through the
column-parallel ``w_i`` and the rank's columns of the replicated ``w_r``,
and the row-parallel ``w_out`` sums over the model axis. The MLP is
Megatron's. The local-attention blocks are MQA with one KV head: its
cache stores the head ``e`` times (``layers.serve_kv_expand``) so that
every rank keeps whole heads, and the rank gathers the wk/wv columns
that cut the head (``layers.cache_heads``). The embedding and the
head are vocabulary-parallel: ``prefill`` and ``decode_step`` return the
rank's vocabulary columns, the engine's paged functions the whole
vocabulary. The state is the rank's: its channels of conv and h, its
cache heads. At one rank every collective is the identity and the code
is the one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from . import layers as L

LRU_C = 8.0                 # Griffin's fixed decay temperature
# sequences longer than this take chunked attention (the reference's
# layers.ATTN_CHUNK_THRESHOLD)
ATTN_CHUNK_THRESHOLD = 2048


# --- params ----------------------------------------------------------------------

def _counts(cfg) -> tuple[int, int]:
    """(num full pattern periods, num trailing rec layers)."""
    period = len(cfg.recurrent.block_pattern)
    return cfg.num_layers // period, cfg.num_layers % period


def _state_counts(cfg) -> tuple[int, int]:
    n_super, n_tail = _counts(cfg)
    return 2 * n_super + n_tail, n_super       # (n_rec, n_attn)


def init_params(cfg, seed: int = 0, device="cuda", local=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``: the
    reference's tree (``super.{rec1,rec2,attn}`` stacked over the
    super-blocks, ``tail`` over the trailing rec layers) and
    distributions, drawn on ``device`` one layer at a time, stored in the
    converter's dtypes (``lam``, ``ln``, ``ln_mlp`` and ``ln_f`` in f32,
    every other leaf in bf16). ``local(path, t)``
    (``launch.sharding.local_init``) keeps a rank's slice of each drawn
    leaf, equal to the one-rank draw's bit for bit."""
    dev = resolve_device(device)
    keep = local or (lambda path, t: t)
    gen = L.seeded_generator(dev, seed)
    D, Fd, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    W = cfg.recurrent.lru_width or D
    cw = cfg.recurrent.conv_width
    n_super, n_tail = _counts(cfg)
    cd = L.COMPUTE_DTYPE

    def normal(shape, std, dtype=cd):
        t = torch.empty(shape, dtype=L.PARAM_DTYPE, device=dev)
        return L.trunc_normal_(t, gen, std).to(dtype)

    def matrix(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def ones(n):
        return torch.ones((n,), dtype=L.PARAM_DTYPE, device=dev)

    def zeros(n):
        return torch.zeros((n,), dtype=cd, device=dev)

    def mlp():
        return {"ln_mlp": ones(D), "w_gate": matrix(D, Fd),
                "w_up": matrix(D, Fd), "w_down": matrix(Fd, D)}

    def rec():
        return {"ln": ones(D), "w_branch": matrix(D, W), "w_x": matrix(D, W),
                "conv_w": normal((cw, W), 1.0 / math.sqrt(cw)),
                "conv_b": zeros(W), "w_i": matrix(W, W), "b_i": zeros(W),
                "w_r": matrix(W, W), "b_r": zeros(W),
                "lam": normal((W,), 0.5, L.PARAM_DTYPE),
                "w_out": matrix(W, D), **mlp()}

    def attn():
        return {"ln": ones(D), "wq": matrix(D, cfg.q_dim),
                "wk": matrix(D, cfg.kv_dim), "wv": matrix(D, cfg.kv_dim),
                "wo": matrix(cfg.q_dim, D), **mlp()}

    def kept(prefix, tree):
        return {k: keep((*prefix, k), t) for k, t in tree.items()}

    params = {"embed": keep(("embed",), normal((V, D), 0.02)),
              "super": L.stack_layers(lambda: {
                  "rec1": kept(("super", "rec1"), rec()),
                  "rec2": kept(("super", "rec2"), rec()),
                  "attn": kept(("super", "attn"), attn())}, n_super, dev),
              "ln_f": ones(D), "lm_head": keep(("lm_head",), matrix(D, V))}
    if n_tail:
        params["tail"] = L.stack_layers(lambda: kept(("tail",), rec()),
                                        n_tail, dev)
    return params


def _layers(cfg, params):
    """(kind, params, rec index or attn index, the FSDP path prefix of its
    leaves) of every layer in order: super-block i is rec 2i, rec 2i + 1,
    attn i; tail layer j is rec 2 * n_super + j. Each stacked leaf is
    unbound once (``layers.layer_views``)."""
    n_super, n_tail = _counts(cfg)
    for i, p in enumerate(L.layer_views(params["super"], n_super)):
        yield "rec", p["rec1"], 2 * i, "super/rec1/"
        yield "rec", p["rec2"], 2 * i + 1, "super/rec2/"
        yield "attn", p["attn"], i, "super/attn/"
    if n_tail:
        for j, p in enumerate(L.layer_views(params["tail"], n_tail)):
            yield "rec", p, 2 * n_super + j, "tail/"


# --- RG-LRU recurrent block ----------------------------------------------------------

def _causal_conv(x, w, b, conv_state, length=None):
    """Depthwise causal conv1d. x: (B, S, W); w: (cw, W); conv_state: (B,
    cw - 1, W) holds the trailing inputs of the previous chunk.
    ``length`` (an int tensor) gates padded prompts: the carried state is
    then the window ending at position length - 1, not at the padded
    end."""
    cw, S = w.shape[0], x.shape[1]
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + S] * w[i] for i in range(cw))
    if cw == 1:
        new_state = conv_state
    elif length is None:
        new_state = xp[:, -(cw - 1):]
    else:           # xp index j holds x position j - (cw - 1)
        idx = length.reshape(()).long() + torch.arange(cw - 1,
                                                       device=x.device)
        new_state = xp.index_select(1, idx)
    return out + b, new_state


def _rglru(x, r_gate, i_gate, lam, h0, length=None):
    """RG-LRU scan in f32. x, gates: (B, S, W); lam (W,); h0: (B, W).
    ``length`` gates padded positions to identity updates (a = 1, input
    0), so the carried hidden is the state after exactly ``length`` live
    tokens. Returns the hidden sequence in x's dtype and the last hidden
    (f32)."""
    a_log = (-LRU_C * F.softplus(lam.float())
             * torch.sigmoid(r_gate.float()))              # (B,S,W) <= 0
    a = torch.exp(a_log)
    gated = torch.sigmoid(i_gate.float()) * x.float()
    scaled = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
    S = x.shape[1]
    if length is not None:
        live = (torch.arange(S, device=x.device)
                < length.reshape(()))[None, :, None]
        a = torch.where(live, a, 1.0)
        scaled = torch.where(live, scaled, 0.0)
    h = h0.float()
    hs = []
    for t in range(S):
        h = torch.addcmul(scaled[:, t], a[:, t], h)
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), h


def _mlp(cfg, p, x):
    h = L.copy_to_tp(L.rmsnorm(x, p["ln_mlp"]).to(L.COMPUTE_DTYPE))
    return L.reduce_rows(L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"]),
                         p["w_down"], cfg.d_ff)


def _rec_block(cfg, p, prefix, x, conv, h, length=None):
    """One recurrent layer from its state (conv (B, cw - 1, W), h (B, W);
    the rank's channels under tensor parallelism): returns (y, new conv
    in conv's dtype, new h f32). ``prefix``: its leaves' path, where FSDP
    splits them (``layers.fsdp_whole``)."""
    p = L.fsdp_whole(p, prefix, layer=True)
    h_in = L.copy_to_tp(L.rmsnorm(x, p["ln"]).to(L.COMPUTE_DTYPE))
    branch = F.gelu(h_in @ p["w_branch"], approximate="tanh")
    xr = h_in @ p["w_x"]
    xr, conv_new = _causal_conv(xr, p["conv_w"], p["conv_b"], conv,
                                length=length)
    W = cfg.recurrent.lru_width or cfg.d_model
    xw = L.gather_from_tp(xr, -1) if xr.shape[-1] != W else xr
    r_gate = xw @ L.tp_part(L.copy_to_tp(p["w_r"])) + p["b_r"]
    i_gate = xw @ p["w_i"] + p["b_i"]
    hseq, h_last = _rglru(xr, r_gate, i_gate, p["lam"], h, length=length)
    y = x + L.reduce_rows((branch * hseq) @ p["w_out"], p["w_out"],
                          W).to(x.dtype)
    y = y + _mlp(cfg, p, y).to(y.dtype)
    return y, conv_new.to(conv.dtype), h_last


# --- local attention blocks ----------------------------------------------------------

def _qkv(cfg, p, x, rope, e: int = 1):
    """Pre-norm, projections and RoPE: q (B, S, heads, dh) and k, v in the
    cache's (B, S, cache heads, dh), the KV head stored ``e`` times; under
    tensor parallelism the rank's heads (``layers.rank_heads``)."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    h = L.copy_to_tp(L.rmsnorm(x, p["ln"]).to(L.COMPUTE_DTYPE))
    hl, ce = L.rank_heads(cfg, p["wq"].shape[-1], e)
    q = L.rotate((h @ p["wq"]).view(B, S, hl, dh), *rope)
    k = L.rotate(L.cache_heads(cfg, h @ p["wk"], e, ce), *rope)
    return q, k, L.cache_heads(cfg, h @ p["wv"], e, ce)


def _attn_finish(cfg, p, x, attn):
    B, S, _ = x.shape
    o = attn.reshape(B, S, -1) @ p["wo"]
    y = x + L.reduce_rows(o, p["wo"], cfg.q_dim).to(x.dtype)
    return y + _mlp(cfg, p, y).to(y.dtype)


def _attn_block_full(cfg, p, prefix, x, rope, e: int = 1):
    """Full-sequence windowed MQA (prefill): returns (y, (k, v)), k and v
    in the cache's heads (the KV head ``e`` times, the rank's share);
    ``prefix`` as ``_rec_block``'s."""
    p = L.fsdp_whole(p, prefix, layer=True)
    S = x.shape[1]
    win = cfg.recurrent.window
    q, k, v = _qkv(cfg, p, x, rope, e)
    if S > ATTN_CHUNK_THRESHOLD:       # long sequence: chunked windowed attn
        attn = L.chunked_attention(q, k, v, causal=True, window=win)
    else:
        attn = L.gqa_attention(q, k, v, mask=L.window_mask(
            S, S, win, device=x.device))
    return _attn_finish(cfg, p, x, attn), (k, v)


def _attn_block_decode(cfg, p, x, ck, cv, kpos, pos: int, rope):
    """One-token windowed MQA against a ring-buffer cache, in place: ck,
    cv (B, window, cache heads, dh) and kpos (B, window) absolute
    positions (-1 empty) of this layer; the token at ``pos`` lands in slot
    pos % window.
    """
    win = cfg.recurrent.window
    q, k, v = _qkv(cfg, p, x, rope, L.kv_expansion(cfg, ck.shape[2]))
    slot = pos % win
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    kpos[:, slot] = pos
    valid = (kpos >= 0) & (kpos <= pos) & (kpos > pos - win)
    attn = L.gqa_attention(q, ck.to(L.COMPUTE_DTYPE), cv.to(L.COMPUTE_DTYPE),
                           mask=valid[:, None, None, None, :])
    return _attn_finish(cfg, p, x, attn)


# --- state -----------------------------------------------------------------------

@dataclasses.dataclass
class GriffinState:
    conv: torch.Tensor      # (n_rec, B, cw-1, W)
    h: torch.Tensor         # (n_rec, B, W) f32
    k: torch.Tensor         # (n_attn, B, window, cache heads, dh)
    v: torch.Tensor
    kpos: torch.Tensor      # (n_attn, B, window) int32, -1 = empty
    pos: int                # tokens consumed (lockstep over the batch)


def _rec_state(cfg, batch_size: int, dtype, dev):
    """Zero (conv, h) of the rank's channels (all of them at one rank)."""
    n_rec, _ = _state_counts(cfg)
    W = (cfg.recurrent.lru_width or cfg.d_model) // L.tp_size()
    cw = cfg.recurrent.conv_width
    return (torch.zeros((n_rec, batch_size, cw - 1, W), dtype=dtype,
                        device=dev),
            torch.zeros((n_rec, batch_size, W), dtype=torch.float32,
                        device=dev))


def init_decode_state(cfg, batch_size: int, cache_len: int = 0,
                      dtype=None, device="cuda",
                      kv_expand: int = 1) -> GriffinState:
    """Zero state for ``batch_size`` sequences (``cache_len`` is unused:
    the ring holds ``window`` slots; each KV head stored ``kv_expand``
    times), in ``dtype`` (the compute dtype by default), on the card
    unless ``device`` says otherwise. Under an installed mesh, this
    rank's part: its channels and its cache heads."""
    dev = resolve_device(device)
    dtype = dtype or L.COMPUTE_DTYPE
    _, n_attn = _state_counts(cfg)
    win = cfg.recurrent.window
    conv, h = _rec_state(cfg, batch_size, dtype, dev)
    shape = (n_attn, batch_size, win,
             L.cache_head_count(cfg, kv_expand), cfg.head_dim)
    return GriffinState(
        conv=conv, h=h,
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        kpos=torch.full((n_attn, batch_size, win), -1, dtype=torch.int32,
                        device=dev),
        pos=0)


# --- forward / prefill ----------------------------------------------------------------

def _head(cfg, params, x):
    """f32 logits: the rank's vocabulary columns under tensor
    parallelism."""
    h = L.rmsnorm(x, params["ln_f"].to(L.COMPUTE_DTYPE))
    return L.head_logits(h, L.fsdp_leaf(params["lm_head"], "lm_head"),
                         cfg.vocab_size)


def _rope(cfg, positions):
    return L.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)


def _super_scan(cfg, params, x, conv, h, length=None, *, advance=True,
                remat=False, e: int = 1):
    """Every layer over the whole sequence from the recurrent state
    (conv, h), which is advanced in place unless ``advance`` is False
    (the training forward, which writes nothing in place). ``length``
    gates the recurrent updates past the live prompt, so a bucket-padded
    prefill carries the state at position length - 1 (pad keys/values are
    masked or overwritten by the reader). ``remat`` recomputes each layer
    in the backward. Returns (hidden, (k, v) each (n_attn, B, S, cache
    heads, dh), the KV head stored ``e`` times)."""
    B, S, _ = x.shape
    rope = _rope(cfg, torch.arange(S, device=x.device).expand(B, S))
    ks, vs = [], []
    for kind, p, i, prefix in _layers(cfg, params):
        if kind == "rec":
            x, c, hh = L.checkpointed(_rec_block, cfg, p, prefix, x,
                                      conv[i], h[i], length, remat=remat)
            if advance:
                conv[i].copy_(c)
                h[i].copy_(hh)
        else:
            x, (k, v) = L.checkpointed(_attn_block_full, cfg, p, prefix,
                                       x, rope, e, remat=remat)
            ks.append(k)
            vs.append(v)
    if not ks:                  # cut below one period: rec layers only
        ks = vs = [x.new_empty((0, B, S, L.cache_head_count(cfg, e),
                                cfg.head_dim), dtype=L.COMPUTE_DTYPE)]
        return x, (torch.cat(ks), torch.cat(vs))
    return x, (torch.stack(ks), torch.stack(vs))


def forward(cfg, params, batch, *, remat=False):
    """Logits (B, S, V) f32 for batch["tokens"] (B, S) from a zero state
    (B, S, V / tp under tensor parallelism, the KV head expanded as
    serving expands it)."""
    tokens = batch["tokens"]
    conv, h = _rec_state(cfg, tokens.shape[0], L.COMPUTE_DTYPE, tokens.device)
    x, _ = _super_scan(cfg, params, L.embed_tokens(cfg, params, tokens), conv, h,
                       advance=False, remat=remat,
                       e=L.serve_kv_expand(cfg, L.tp_size()))
    return _head(cfg, params, x)


def loss_fn(cfg, params, batch, *, remat=True):
    """Mean cross-entropy (with the z-loss) of the next tokens: the
    reference's training loss (vocabulary-parallel under tensor
    parallelism)."""
    logits = forward(cfg, params, batch, remat=remat)
    return L.mean_xent(logits, batch["labels"], cfg.vocab_size)


def prefill(cfg, params, batch, cache_len: int = 0, kv_expand: int = 1):
    """The prompt from a zero state: the last position's logits (B, V)
    and the state after it, the last ``window`` keys/values in their ring
    slots (position p at slot p % window; ``cache_len`` is unused), each
    KV head stored ``kv_expand`` times (MQA's one head replicated)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    win = cfg.recurrent.window
    state = init_decode_state(cfg, B, device=tokens.device,
                              kv_expand=kv_expand)
    x, (k_all, v_all) = _super_scan(
        cfg, params, L.embed_tokens(cfg, params, tokens), state.conv, state.h,
        e=kv_expand)
    n_attn = k_all.shape[0]
    dev = tokens.device
    if S >= win:
        shift = S % win
        state.k.copy_(torch.roll(k_all[:, :, -win:], shift, dims=2))
        state.v.copy_(torch.roll(v_all[:, :, -win:], shift, dims=2))
        kp = torch.arange(S - win, S, dtype=torch.int32, device=dev)
        state.kpos.copy_(torch.roll(kp, shift).expand(n_attn, B, win))
    else:
        state.k[:, :, :S] = k_all
        state.v[:, :, :S] = v_all
        state.kpos[:, :, :S] = torch.arange(S, dtype=torch.int32, device=dev)
    state.pos = S
    return _head(cfg, params, x[:, -1:])[:, 0], state


def decode_step(cfg, params, state: GriffinState, tokens):
    """One token per sequence, tokens (B,): logits (B, V) and ``state``,
    advanced in place."""
    B = tokens.shape[0]
    pos = state.pos
    rope = _rope(cfg, torch.full((B, 1), pos, device=tokens.device))
    x = L.embed_tokens(cfg, params, tokens[:, None])
    for kind, p, i, prefix in _layers(cfg, params):
        if kind == "rec":
            x, c, hh = _rec_block(cfg, p, prefix, x, state.conv[i],
                                  state.h[i])
            state.conv[i].copy_(c)
            state.h[i].copy_(hh)
        else:
            x = _attn_block_decode(cfg, p, x, state.k[i], state.v[i],
                                   state.kpos[i], pos, rope)
    state.pos = pos + 1
    return _head(cfg, params, x)[:, 0], state


# --- paged-window decode (continuous batching) ------------------------------------
# The hybrid serving shape: the recurrent state is constant per slot (conv +
# LRU hidden), while the window KV lives in a shared page pool addressed
# through a page-granular ring: token t sits in page t // page, ring row
# (t // page) % R with R = ceil(window / page) + 1, so a slot holds at most
# R pages however long the request runs, and the engine recycles the page
# that falls out of the window at every wrap.


def ring_rows(window: int, page_size: int) -> int:
    """Table rows of the page-granular window ring. R * page covers the
    window plus one page of slack, so the page evicted on wrap is always
    wholly out of the attention window (the in-window tail of the oldest
    page is masked by position arithmetic, not by eviction)."""
    return -(-window // page_size) + 1


@dataclasses.dataclass
class GriffinPagedState:
    conv: torch.Tensor      # (n_rec, B, cw-1, W)
    h: torch.Tensor         # (n_rec, B, W) f32
    k_pages: torch.Tensor   # (n_attn, KV, P, page, dh); page 0 = trash
    v_pages: torch.Tensor


def init_paged_decode_state(cfg, num_slots: int, num_pages: int,
                            page_size: int, dtype=None, device="cuda",
                            kv_expand: int = 1) -> GriffinPagedState:
    """Per-slot recurrent state and page pools of the cache heads (the KV
    head stored ``kv_expand`` times), in ``dtype`` (the compute dtype by
    default); under an installed mesh this rank's part: its channels and
    its cache heads."""
    dev = resolve_device(device)
    dtype = dtype or L.COMPUTE_DTYPE
    _, n_attn = _state_counts(cfg)
    conv, h = _rec_state(cfg, num_slots, dtype, dev)
    k, v = L.paged_cache_init(n_attn, num_pages, page_size,
                              L.cache_head_count(cfg, kv_expand),
                              cfg.head_dim, dtype, dev)
    return GriffinPagedState(conv=conv, h=h, k_pages=k, v_pages=v)


def paged_prefill(cfg, params, batch, length, kv_expand: int = 1):
    """Forward a (bucket-padded) B = 1 prompt; return the last live
    token's logits (1, V) (the whole vocabulary's: the engine samples
    them), the raw per-position attention KV for the page scatter ((k, v)
    each (n_attn, 1, S, cache heads, dh), the KV head stored
    ``kv_expand`` times, the rank's share) and the recurrent state at
    ``length`` (conv (n_rec, 1, cw - 1, W), h (n_rec, 1, W) f32): pad
    tokens past the live prompt leave conv and h untouched, and their KV
    is masked or overwritten by the paged reader."""
    tokens = batch["tokens"]
    conv, h = _rec_state(cfg, tokens.shape[0], L.COMPUTE_DTYPE, tokens.device)
    x, (k, v) = _super_scan(cfg, params, L.embed_tokens(cfg, params, tokens), conv,
                            h, length=length, e=kv_expand)
    idx = (length.reshape(()).long() - 1).reshape(1)
    last = _head(cfg, params, x.index_select(1, idx))[:, 0]
    return L.whole_vocab(last, cfg.vocab_size), (k, v), conv, h


def write_prefill_state(cfg, state: GriffinPagedState, kv, conv, h,
                        page_ids, slot: int) -> None:
    """Scatter one prefilled request's window KV into its pages and its
    recurrent state into batch slot ``slot``, in place. kv: (k, v) each
    (n_attn, S, KV, dh) with S a page multiple; page_ids (S / page,) with
    the entries of out-of-window and pad pages on the trash page."""
    k, v = kv
    state.conv[:, slot].copy_(conv[:, 0])
    state.h[:, slot].copy_(h[:, 0])
    L.paged_cache_write_prompt(state.k_pages, k, page_ids)
    L.paged_cache_write_prompt(state.v_pages, v, page_ids)


def _attn_block_paged(cfg, p, x, kp, vp, pt, pos, active, rope):
    """One-token windowed MQA against the shared page pool, S == 1.

    kp/vp: (KV, P, page, dh) pool views of this layer, appended in place;
    pt: (B, R) ring rows of the page table; pos: (B,) absolute position
    of the token being decoded. The absolute position of ring entry (row,
    offset) is rebuilt from pos (the page in row r is the largest page
    number n = r mod R with n <= pos // page), so no position array is
    stored and the in-window mask is exact (as ``_attn_block_decode``'s).
    """
    B = x.shape[0]
    win = cfg.recurrent.window
    KV, _, page, dh = kp.shape                  # the pool's heads
    R = pt.shape[1]
    q, k, v = _qkv(cfg, p, x, rope, L.kv_expansion(cfg, KV))
    cp = pos // page                            # current page number
    page_ids = torch.gather(pt, 1, (cp % R)[:, None].long())[:, 0]
    page_ids = torch.where(active, page_ids, 0)     # inactive -> trash
    offsets = torch.where(active, pos % page, 0)
    L.paged_cache_append(kp, k[:, 0], page_ids, offsets)
    L.paged_cache_append(vp, v[:, 0], page_ids, offsets)

    rows = pt.long()
    gk = kp[:, rows].permute(1, 2, 3, 0, 4).reshape(B, R * page, KV, dh)
    gv = vp[:, rows].permute(1, 2, 3, 0, 4).reshape(B, R * page, KV, dh)
    r_idx = torch.arange(R, dtype=torch.int32, device=x.device)
    n = cp[:, None] - ((cp[:, None] - r_idx[None, :]) % R)      # (B, R)
    absp = (n[:, :, None] * page + torch.arange(
        page, dtype=torch.int32, device=x.device)).reshape(B, R * page)
    valid = (absp >= 0) & (absp <= pos[:, None]) \
        & (absp > pos[:, None] - win)
    valid &= torch.repeat_interleave(pt != 0, page, dim=1)  # empty rows
    # inactive slots attend to one (garbage, finite) entry so the softmax
    # stays defined; the engine discards their outputs
    first = torch.arange(R * page, device=x.device)[None, :] == 0
    valid = torch.where(active[:, None], valid, first)
    attn = L.gqa_attention(q, gk, gv, mask=valid[:, None, None, None, :])
    return _attn_finish(cfg, p, x, attn)


def paged_decode_step(cfg, params, state: GriffinPagedState, tokens,
                      page_table, lengths, active):
    """One token per slot: per-slot recurrent state plus paged window KV,
    updated in place; returns logits (B, V).

    tokens (B,) int; page_table (B, M) int32 whose first R columns are
    the window ring; lengths (B,) the decoding position per slot; active
    (B,) bool: inactive slots write to the trash page and freeze their
    recurrent state. The caller advances lengths. The logits are the
    whole vocabulary's (gathered under tensor parallelism): the engine
    samples them."""
    page = state.k_pages.shape[3]
    R = ring_rows(cfg.recurrent.window, page)
    pt = page_table[:, :R]
    active = active.to(torch.bool)
    pos = torch.where(active, lengths.to(torch.int32), 0)
    rope = _rope(cfg, pos[:, None])
    keep = active[:, None]
    x = L.embed_tokens(cfg, params, tokens[:, None])
    for kind, p, i, prefix in _layers(cfg, params):
        if kind == "rec":
            conv, h = state.conv[i], state.h[i]
            x, c, hh = _rec_block(cfg, p, prefix, x, conv, h)
            conv.copy_(torch.where(keep[:, :, None], c, conv))
            h.copy_(torch.where(keep, hh, h))
        else:
            x = _attn_block_paged(cfg, p, x, state.k_pages[i],
                                  state.v_pages[i], pt, pos, active, rope)
    return L.whole_vocab(_head(cfg, params, x)[:, 0], cfg.vocab_size)


def paged_decode_multi(cfg, params, state: GriffinPagedState, pending,
                       lengths, remaining, page_table, mask, h: int, *,
                       hmax: int, teacher=None):
    """Up to ``h`` fused ``paged_decode_step``s with greedy sampling on
    the device (``layers.multi_step_decode``); the loop tensors advance in
    place. The engine clamps ``h`` at page boundaries, which for the
    window ring is exactly the wrap point, so the ring never recycles a
    page mid-horizon and the table stays constant. Returns the (hmax, B)
    tokens."""
    def step(toks, pt, lens, act):
        return paged_decode_step(cfg, params, state, toks, pt, lens, act)
    return L.multi_step_decode(step, hmax, pending, lengths, remaining,
                               page_table, mask, h, teacher)
