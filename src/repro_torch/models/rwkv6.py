"""RWKV-6 "Finch" (arXiv:2404.05892), attention-free, in PyTorch.

Counterpart of ``repro.models.rwkv6``, serving and the training loss
(``loss_fn``; ``forward`` from a zero state writes nothing in place and
can recompute each block in the backward). Per block: time-mix
(token-shift ddlerp -> r/k/v/w/g projections -> WKV linear recurrence
with data-dependent decay w_t and bonus u -> per-head group norm) and
channel-mix (squared-ReLU FFN gated by sigmoid(r)). The reference's ``lax.scan`` over layers is a Python loop
here; the WKV recurrence is plain torch ops, as the reference's is jnp
(no Pallas site).

State per layer: the two token-shift registers (the last normed x seen
by time-mix and by channel-mix) and the WKV matrix state (B, H, dk, dv),
O(1) per decoded token. ``decode_step`` updates a state's tensors in
place (``copy_``), so a CUDA graph of the step (``runtime.DecodeGraph``)
holds their addresses.

Numerics copied from the reference on purpose: the WKV state lives in
bf16 between calls (``init_decode_state`` uses the compute dtype) while
both WKV routines compute in f32; every parameter is cast to bf16 at use,
the layernorm scales too (the converter keeps ``ln1``/``ln2``/``ln1b``/
``ln2b``/``ln_f`` in f32); the decay is exp(-exp(w_log in f32)) rounded
to bf16; S > 1 takes the chunked WKV with a chunk of gcd(S, 32) (the scan
below 2), S = 1 the scan.

Tensor parallelism (under a mesh installed by ``layers.set_shard_ctx``;
each rank holds its slices of the params by the reference's rules,
``launch.sharding.param_pspecs``): the ddlerp's lora input ``mix_w1`` is
replicated but ``mix_w2`` column-parallel, so its adjustment comes out
split over D and is gathered whole (``layers.gather_whole``) before the
five mixed streams feed the column-parallel wr/wk/wv/wg, which give the
rank's heads. The decay lora's ``w_lora_a`` and ``w_lora_b`` are both
column-parallel: the low-rank activation is gathered between them
(``gather_from_tp``: each rank then uses it for its own channels).
``w_base``, ``gn``, ``gnb`` and the per-head bonus ``u`` are the rank's,
so the decay, the WKV recurrence and the group norm run on the rank's
heads, and the row-parallel ``wo`` sums over the model axis. In the
channel mix the row-parallel ``ffn_v`` sums its partial products, and
the column-parallel ``ffn_r``'s gate is gathered whole. The embedding
and the head are vocabulary-parallel (``prefill`` and ``decode_step``
return the rank's vocabulary columns, the engine's ``decode_multi`` the
whole vocabulary). The state is the rank's: the WKV matrices of its heads
and its D slice of each token-shift register (gathered where used), as
``launch.sharding.state_pspecs`` splits them. At one rank every
collective is the identity and the code is the one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from . import layers as L
from .transformer import F32_PARAMS

MIX_LORA = 32     # token-shift ddlerp lora rank
DECAY_LORA = 64   # data-dependent decay lora rank
STREAMS = 5       # r, k, v, w, g
WKV_CHUNK = 32


# --- params ----------------------------------------------------------------------

def init_params(cfg, seed: int = 0, device="cuda", local=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``: the
    reference's tree and distributions, drawn on ``device`` one layer at a
    time, stored in the converter's dtypes (``transformer.F32_PARAMS`` in
    f32, every other leaf in bf16). ``local(path, t)``
    (``launch.sharding.local_init``) keeps a rank's slice of each drawn
    leaf, equal to the one-rank draw's bit for bit."""
    dev = resolve_device(device)
    keep = local or (lambda path, t: t)
    gen = L.seeded_generator(dev, seed)
    D, Fd, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, dh = cfg.num_heads, cfg.head_dim
    assert H * dh == D
    cd = L.COMPUTE_DTYPE

    def normal(shape, std=0.02):
        t = torch.empty(shape, dtype=L.PARAM_DTYPE, device=dev)
        return L.trunc_normal_(t, gen, std).to(cd)

    def matrix(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def const(name, value):
        return torch.full((D,), value, device=dev, dtype=(
            L.PARAM_DTYPE if name in F32_PARAMS else cd))

    def layer():
        return {k: keep(("blocks", k), t) for k, t in draw_layer().items()}

    def draw_layer():
        return {
            **{n: const(n, 1.0) for n in ("ln1", "ln2", "gn")},
            **{n: const(n, 0.0) for n in ("ln1b", "ln2b", "gnb")},
            "mu_base": normal((STREAMS, D), std=0.1),
            "mix_w1": normal((D, STREAMS * MIX_LORA)),
            "mix_w2": normal((STREAMS, MIX_LORA, D)),
            **{n: matrix(D, D) for n in ("wr", "wk", "wv", "wg", "wo")},
            "w_base": normal((D,), std=0.5),
            "w_lora_a": normal((D, DECAY_LORA)),
            "w_lora_b": normal((DECAY_LORA, D)),
            "u": normal((H, dh), std=0.5),
            "mu_ffn": normal((2, D), std=0.1),
            "ffn_k": matrix(D, Fd), "ffn_v": matrix(Fd, D),
            "ffn_r": matrix(D, D),
        }

    return {"embed": keep(("embed",), normal((V, D))),
            "ln_in": const("ln_in", 1.0), "ln_inb": const("ln_inb", 0.0),
            "blocks": L.stack_layers(layer, cfg.num_layers, dev),
            "ln_f": const("ln_f", 1.0), "ln_fb": const("ln_fb", 0.0),
            "lm_head": keep(("lm_head",), matrix(D, V))}


# --- time mix --------------------------------------------------------------------

def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation -> the 5 mixed streams,
    whole on every rank (the column-parallel ``mix_w2``'s adjustment
    gathered)."""
    delta = x_prev - x                                          # (B,S,D)
    xx = x + delta * p["mu_base"][0]  # base mix for the lora input
    lora = torch.tanh(xx @ p["mix_w1"])                         # (B,S,5*r)
    B, S, _ = lora.shape
    lora = L.copy_to_tp(lora.view(B, S, STREAMS, MIX_LORA))
    adj = torch.einsum("bsnr,nrd->bnsd", lora, p["mix_w2"])     # (B,5,S,D)
    if adj.shape[-1] != x.shape[-1]:        # mix_w2 column-parallel
        adj = L.gather_whole(adj, -1)
    mixed = x[:, None] + delta[:, None] * (p["mu_base"][None, :, None] + adj)
    return mixed.unbind(1)                                      # 5 x (B,S,D)


def _wkv_scan(r, k, v, w, u, state):
    """WKV linear recurrence, token by token, in f32.
    r, k, w: (B, S, H, dk); v: (B, S, H, dv); u: (H, dk); state: (B, H,
    dk, dv). Returns y (B, S, H, dv) and the new state, in r's dtype."""
    u = u.float()[None, :, :, None]
    S_ = state.float()
    ys = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, w_t = (a[:, t].float() for a in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]             # (B,H,dk,dv)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_t, S_ + u * kv))
        S_ = w_t[..., :, None] * S_ + kv
    return torch.stack(ys, 1).to(r.dtype), S_.to(r.dtype)


def _wkv_chunked(r, k, v, w, u, state, chunk=WKV_CHUNK):
    """Chunk-parallel WKV, the same recurrence: with cumulative decays
    cs = cumsum(log w) inside a chunk,

        y_i = (r_i * e^{cs_{i-1}}) @ S_in
            + sum_{j<i} <r_i, k_j * e^{cs_{i-1}-cs_j}> v_j
            + <r_i, u * k_i> v_i
        S_out = e^{cs_last} * S_in + sum_j (k_j * e^{cs_last-cs_j}) v_j^T

    every exponent <= 0. f32 math; the chunk is gcd(S, chunk), and below
    2 the scan runs instead."""
    B, S, H, dk = r.shape
    dv = v.shape[-1]
    if S % chunk:
        chunk = math.gcd(S, chunk) or 1
    if chunk <= 1:
        return _wkv_scan(r, k, v, w, u, state)
    n = S // chunk
    rc, kc, vc, wc = (t.reshape(B, n, chunk, H, t.shape[-1]).float()
                      for t in (r, k, v, w))                # (B,n,C,H,d)
    u32 = u.float()
    dev = r.device
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=dev), -1)[None, :, :, None, None]
    eye = torch.eye(chunk, device=dev)[None, :, :, None]
    S_ = state.float()
    ys = []
    for c in range(n):
        rq, kq, vq, wq = rc[:, c], kc[:, c], vc[:, c], wc[:, c]  # (B,C,H,d)
        logw = torch.clamp_min(torch.log(wq), -30.0)
        cs = torch.cumsum(logw, dim=1)                          # (B,C,H,dk)
        cs_prev = cs - logw                                     # exclusive
        # inter-chunk: read the carried state once
        y_inter = torch.einsum("bchk,bhkv->bchv", rq * torch.exp(cs_prev), S_)
        # intra-chunk: masked per-channel decay contraction
        expo = cs_prev[:, :, None] - cs[:, None]                # (B,C,C,H,dk)
        decay = torch.exp(torch.where(tri, expo, -math.inf))
        a = (rq[:, :, None] * kq[:, None] * decay).sum(-1)      # (B,C,C,H)
        diag = (rq * u32 * kq).sum(-1)                          # (B,C,H)
        a = a + diag[:, :, None] * eye
        ys.append(y_inter + torch.einsum("bijh,bjhv->bihv", a, vq))
        # carry the state across the chunk boundary
        decay_out = torch.exp(cs[:, -1:] - cs)                  # (B,C,H,dk)
        S_ = torch.exp(cs[:, -1])[..., None] * S_ \
            + torch.einsum("bchk,bchv->bhkv", kq * decay_out, vq)
    y = torch.stack(ys, 1).reshape(B, S, H, dv)
    return y.to(r.dtype), S_.to(r.dtype)


def _shifted(x, x_prev_last):
    """x (B, S, D) shifted one token: the carried register (this rank's
    D slice, gathered whole) then x[:, :-1]."""
    return torch.cat([L.tp_all_gather(x_prev_last, -1)[:, None], x[:, :-1]],
                     dim=1)


def _time_mix(cfg, p, x, x_prev_last, wkv_state):
    """x: (B, S, D); x_prev_last: (B, D) carry from the previous call (a
    rank's D slice under tensor parallelism). Returns (out, the last x
    (the rank's slice), the new WKV state of the rank's heads)."""
    B, S, D = x.shape
    dh = cfg.head_dim
    xr, xk, xv, xw, xg = (L.copy_to_tp(t)
                          for t in _ddlerp(p, x, _shifted(x, x_prev_last)))
    H = L.whole_heads(cfg, p["wr"].shape[-1], "wr")     # the rank's heads
    r = (xr @ p["wr"]).view(B, S, H, dh)
    k = (xk @ p["wk"]).view(B, S, H, dh)
    v = (xv @ p["wv"]).view(B, S, H, dh)
    g = F.silu(xg @ p["wg"])
    a = torch.tanh(xw @ p["w_lora_a"])
    if a.shape[-1] != DECAY_LORA:           # w_lora_a column-parallel
        a = L.gather_from_tp(a, -1)
    w_log = p["w_base"] + a @ p["w_lora_b"]
    w = torch.exp(-torch.exp(w_log.float())).to(L.COMPUTE_DTYPE)
    wkv = _wkv_chunked if S > 1 else _wkv_scan
    y, wkv_state = wkv(r, k, v, w.view(B, S, H, dh), p["u"], wkv_state)
    # per-head group norm (no scale), then the learned gn/gnb
    y = L.layernorm(y, None).reshape(B, S, H * dh) * p["gn"] + p["gnb"]
    out = L.reduce_rows((y * g) @ p["wo"], p["wo"], D)
    return out.to(x.dtype), L.tp_part(x[:, -1]), wkv_state


def _channel_mix(cfg, p, x, x_prev_last):
    delta = _shifted(x, x_prev_last) - x
    D = x.shape[-1]
    xk = L.copy_to_tp(x + delta * p["mu_ffn"][0])
    xr = L.copy_to_tp(x + delta * p["mu_ffn"][1])
    k = torch.square(torch.relu(xk @ p["ffn_k"]))
    r = xr @ p["ffn_r"]
    if r.shape[-1] != D:                    # ffn_r column-parallel
        r = L.gather_whole(r, -1)
    kv = L.reduce_rows(k @ p["ffn_v"], p["ffn_v"], cfg.d_ff)
    return torch.sigmoid(r) * kv, L.tp_part(x[:, -1])


def _block(cfg, p, x, att_prev, ffn_prev, wkv_state):
    cd = L.COMPUTE_DTYPE
    p = L.fsdp_whole(p, "blocks/", layer=True)
    pc = {k: w.to(cd) for k, w in p.items()}    # every leaf in bf16
    h = L.layernorm(x, pc["ln1"], pc["ln1b"]).to(cd)
    att, att_last, wkv_state = _time_mix(cfg, pc, h, att_prev, wkv_state)
    x = x + att.to(x.dtype)
    h2 = L.layernorm(x, pc["ln2"], pc["ln2b"]).to(cd)
    ffn, ffn_last = _channel_mix(cfg, pc, h2, ffn_prev)
    return x + ffn.to(x.dtype), att_last, ffn_last, wkv_state


# --- state -----------------------------------------------------------------------

@dataclasses.dataclass
class RwkvState:
    att_prev: torch.Tensor  # (L, B, D) last normed x seen by time-mix
    ffn_prev: torch.Tensor  # (L, B, D)
    wkv: torch.Tensor       # (L, B, H, dk, dv), bf16 as in the reference
    pos: int                # tokens consumed (lockstep paths only)


def init_decode_state(cfg, batch_size: int, cache_len: int = 0,
                      dtype=None, device="cuda",
                      kv_expand: int = 1) -> RwkvState:
    """Zero state for ``batch_size`` sequences (``cache_len`` and
    ``kv_expand`` are unused: the state does not grow and holds no KV
    heads), in ``dtype`` (the compute dtype by default), on the card
    unless ``device`` says otherwise. Under an installed mesh, this
    rank's part: its heads' WKV matrices and its D slice of each
    register."""
    dev = resolve_device(device)
    dtype = dtype or L.COMPUTE_DTYPE
    tp = L.tp_size()
    Lr, D = cfg.num_layers, cfg.d_model // tp
    H, dh = cfg.num_heads // tp, cfg.head_dim
    return RwkvState(
        att_prev=torch.zeros((Lr, batch_size, D), dtype=dtype, device=dev),
        ffn_prev=torch.zeros((Lr, batch_size, D), dtype=dtype, device=dev),
        wkv=torch.zeros((Lr, batch_size, H, dh, dh), dtype=dtype, device=dev),
        pos=0)


# --- forward / prefill / decode ----------------------------------------------------

def _logits(cfg, params, tokens, state: RwkvState, remat=False):
    """tokens (B, S) through every block from ``state``, which is only
    read: returns logits (B, S, V) f32 and each layer's new (att_prev,
    ffn_prev, wkv). ``remat`` recomputes each block in the backward.
    Under tensor parallelism the logits are the rank's vocabulary
    columns (B, S, V / tp)."""
    cd = L.COMPUTE_DTYPE
    x = L.embed_rows(L.fsdp_leaf(params["embed"], "embed").to(cd), tokens,
                     cfg.vocab_size)
    x = L.layernorm(x, params["ln_in"].to(cd), params["ln_inb"].to(cd))
    new = []
    for i, p in enumerate(L.layer_views(params["blocks"], cfg.num_layers)):
        x, ap, fp, wkv = L.checkpointed(
            _block, cfg, p, x, state.att_prev[i], state.ffn_prev[i],
            state.wkv[i], remat=remat)
        new.append((ap, fp, wkv))
    h = L.layernorm(x, params["ln_f"].to(cd), params["ln_fb"].to(cd))
    return L.head_logits(h, L.fsdp_leaf(params["lm_head"], "lm_head")
                         .to(cd), cfg.vocab_size), new


def _run(cfg, params, tokens, state: RwkvState):
    """tokens (B, S) through every block from ``state``, which is advanced
    in place; returns logits (B, S, V) f32."""
    logits, new = _logits(cfg, params, tokens, state)
    for i, (ap, fp, wkv) in enumerate(new):
        state.att_prev[i].copy_(ap)
        state.ffn_prev[i].copy_(fp)
        state.wkv[i].copy_(wkv)
    state.pos += tokens.shape[1]
    return logits


def forward(cfg, params, batch, *, remat=False):
    """Logits (B, S, V) f32 for batch["tokens"] (B, S) from a zero state."""
    tokens = batch["tokens"]
    state = init_decode_state(cfg, tokens.shape[0], device=tokens.device)
    return _logits(cfg, params, tokens, state, remat=remat)[0]


def loss_fn(cfg, params, batch, *, remat=True):
    """Mean cross-entropy (with the z-loss) of the next tokens: the
    reference's training loss (vocabulary-parallel under tensor
    parallelism)."""
    logits = forward(cfg, params, batch, remat=remat)
    return L.mean_xent(logits, batch["labels"], cfg.vocab_size)


def prefill(cfg, params, batch, cache_len: int = 0, kv_expand: int = 1):
    """The prompt from a zero state: the last position's logits (B, V)
    and the state after it (``cache_len`` and ``kv_expand`` are
    unused)."""
    tokens = batch["tokens"]
    state = init_decode_state(cfg, tokens.shape[0], device=tokens.device)
    return _run(cfg, params, tokens, state)[:, -1], state


def decode_step(cfg, params, state: RwkvState, tokens):
    """One token per sequence, tokens (B,): logits (B, V) and ``state``,
    advanced in place."""
    return _run(cfg, params, tokens[:, None], state)[:, 0], state


def decode_multi(cfg, params, state: RwkvState, pending, lengths, remaining,
                 mask, h: int, *, hmax: int, teacher=None):
    """Up to ``h`` fused ``decode_step``s with greedy sampling on the
    device (``layers.multi_step_decode``). The recurrence has no pages,
    so the shared loop gets a dummy one-column table; masked-out slots
    consume token 0 every step, as the per-step engine feeds them (their
    state is overwritten at the next admission). The step's logits are
    the whole vocabulary's (gathered under tensor parallelism)."""
    def step(toks, pt, lens, act):
        return L.whole_vocab(decode_step(cfg, params, state, toks)[0],
                             cfg.vocab_size)
    dummy = torch.zeros((pending.shape[0], 1), dtype=torch.int32,
                        device=pending.device)
    return L.multi_step_decode(step, hmax, pending, lengths, remaining,
                               dummy, mask, h, teacher)
