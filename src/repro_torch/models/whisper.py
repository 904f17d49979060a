"""Whisper-tiny encoder-decoder backbone (arXiv:2212.04356), in PyTorch.

Counterpart of ``repro.models.whisper``. The conv audio frontend is a
stub, as in the reference: a batch carries precomputed frame embeddings
``frames`` (B, T_enc, D). The encoder is bidirectional; each decoder
block has causal self-attention over its own cache, cross-attention over
the encoder output, and a tanh-GELU MLP; layernorms with biases, tied f32
logits, learned positions taken modulo the 8,192-row ``dec_pos`` table.

Attention: the encoder, and the decoder's self- and cross-attention over
whole sequences, go through ``ops.flash_attention`` (``causal=False``
where the reference passes no mask); a decode step's one query through
``ops.decode_attention`` — over the self-attention cache with
``lengths = pos + 1``, and over the encoder output with ``lengths =
T_enc``. The reference's decode step recomputes the cross K/V from
``enc_out`` at every step (its docstring says "computed once at
prefill"); the port computes what that code computes.

Weights: as the other models, bf16 matrices, embeddings, positions and
biases (the reference casts each to bf16 at use), f32 layernorm scales
and biases (added in f32).

Tensor parallelism (under a mesh installed by ``layers.set_shard_ctx``;
each rank holds its slices of the params by the reference's rules,
``launch.sharding.param_pspecs``): the encoder's and the decoder's
self-attention and MLP take the dense split (column-parallel wq/wk/wv
with their biases bq/bv and w_up with b_up, row-parallel wo and w_down
summed over the model axis before their replicated biases bo and
b_down), the cross attention too (x_wq/x_wk/x_wv column-parallel over
the replicated encoder output, x_wo row-parallel). The positions are
replicated, the tied embedding vocabulary-parallel where its rows divide
the model axis (``prefill`` and ``decode_step`` then return the rank's
vocabulary columns). A split that cuts a head raises (whisper-tiny's six
heads over four ranks): the cache holds the rank's whole heads, as the
reference's ``kv_expand`` is accepted and unused. At one rank every
collective is the identity and the code is the one device's.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..kernels import ops
from . import layers as L

DEC_POS_ROWS = 8192


# --- params ----------------------------------------------------------------------

def init_params(cfg, seed: int = 0, device="cuda", local=None):
    """Random weights from a ``torch.Generator`` seeded with ``seed``:
    the reference's shapes and distributions (truncated normal, std
    1/sqrt(d_in) for matrices, 0.02 for the embedding, 0.01 for the
    position tables; zero biases, unit layernorm scales), on ``device``.
    ``local(path, t)`` (``launch.sharding.local_init``) keeps a rank's
    slice of each drawn leaf, equal to the one-rank draw's bit for bit."""
    dev = resolve_device(device)
    keep = local or (lambda path, t: t)
    gen = L.seeded_generator(dev, seed)
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    Q, KV = cfg.q_dim, cfg.kv_dim

    def normal(shape, std):
        t = torch.empty(shape, dtype=L.PARAM_DTYPE, device=dev)
        return L.trunc_normal_(t, gen, std).to(L.COMPUTE_DTYPE)

    def dense(d_in, d_out):
        return normal((d_in, d_out), 1.0 / math.sqrt(d_in))

    def zeros(n, dtype=L.COMPUTE_DTYPE):
        return torch.zeros(n, dtype=dtype, device=dev)

    def norms(*names):              # layernorm scale ``n``, bias ``n + "b"``
        out = {}
        for n in names:
            out[n] = torch.ones(D, dtype=L.PARAM_DTYPE, device=dev)
            out[n + "b"] = zeros(D, L.PARAM_DTYPE)
        return out

    def attn(prefix=""):
        return {prefix + "wq": dense(D, Q), prefix + "wk": dense(D, KV),
                prefix + "wv": dense(D, KV), prefix + "wo": dense(Q, D),
                prefix + "bq": zeros(Q), prefix + "bv": zeros(KV),
                prefix + "bo": zeros(D)}

    def mlp():
        return {"w_up": dense(D, F), "b_up": zeros(F),
                "w_down": dense(F, D), "b_down": zeros(D)}

    def kept(name, tree):
        return {k: keep((name, k), t) for k, t in tree.items()}

    enc = L.stack_layers(lambda: kept("enc_blocks", {
        **norms("ln1", "ln2"), **attn(), **mlp()}), cfg.encoder.num_layers,
        dev)
    dec = L.stack_layers(lambda: kept("dec_blocks", {
        **norms("ln1", "ln_x", "ln2"), **attn(), **attn("x_"), **mlp()}),
        cfg.num_layers, dev)
    return {"enc_pos": normal((cfg.encoder.seq_len, D), 0.01),
            "enc_blocks": enc, **norms("enc_ln"),
            "embed": keep(("embed",), normal((V, D), 0.02)),
            "dec_pos": normal((DEC_POS_ROWS, D), 0.01),
            "dec_blocks": dec, **norms("dec_ln")}


def _layer(blocks, i: int) -> dict:
    return {k: w[i] for k, w in blocks.items()}


# --- attention pieces --------------------------------------------------------------

def _heads(cfg, t, what: str):
    """(B, S, n * dh) -> (B, S, n, dh): the rank's whole heads of the
    projection ``what`` (raises where its split cuts a head)."""
    return t.view(*t.shape[:2], L.whole_heads(cfg, t.shape[-1], what),
                  cfg.head_dim)


def _q(cfg, p, h, prefix=""):
    return _heads(cfg, h @ p[prefix + "wq"] + p[prefix + "bq"],
                  prefix + "wq")


def _kv(cfg, p, h, prefix=""):
    """Keys carry no bias in whisper; values do."""
    return (_heads(cfg, h @ p[prefix + "wk"], prefix + "wk"),
            _heads(cfg, h @ p[prefix + "wv"] + p[prefix + "bv"],
                   prefix + "wv"))


def _out(cfg, p, attn, prefix=""):
    """The output projection, summed over the model axis where it is
    row-parallel, then its bias."""
    B, S = attn.shape[:2]
    w = p[prefix + "wo"]
    return L.reduce_rows(attn.reshape(B, S, -1) @ w, w, cfg.q_dim) \
        + p[prefix + "bo"]


def _mlp(cfg, p, h):
    return L.gelu_mlp(h, p["w_up"], p["b_up"], p["w_down"], p["b_down"],
                      cfg.d_ff)


# --- encoder / decoder -----------------------------------------------------------

def _enc_block(cfg, p, x):
    """One encoder block: bidirectional self-attention, MLP."""
    cd = L.COMPUTE_DTYPE
    p = L.fsdp_whole(p, "enc_blocks/", layer=True)
    h = L.copy_to_tp(L.layernorm(x, p["ln1"], p["ln1b"]).to(cd))
    k, v = _kv(cfg, p, h)
    attn = ops.flash_attention(_q(cfg, p, h), k, v, causal=False)
    x = x + _out(cfg, p, attn).to(x.dtype)
    h2 = L.copy_to_tp(L.layernorm(x, p["ln2"], p["ln2b"]).to(cd))
    return x + _mlp(cfg, p, h2).to(x.dtype)


def encode(cfg, params, frames, remat=False):
    """frames (B, T_enc, D) precomputed embeddings -> (B, T_enc, D) bf16,
    bidirectional self-attention through the flash kernel. ``remat``
    recomputes each block in the backward."""
    cd = L.COMPUTE_DTYPE
    x = frames.to(cd) + params["enc_pos"][None]
    for p in L.layer_views(params["enc_blocks"], cfg.encoder.num_layers):
        x = L.checkpointed(_enc_block, cfg, p, x, remat=remat)
    return L.layernorm(x, params["enc_ln"], params["enc_lnb"]).to(cd)


def _dec_block(cfg, p, x, enc_out, cache=None):
    """One decoder block. ``cache`` None: x is a whole sequence (causal
    self-attention, cross-attention over every frame, both through the
    flash kernel). Else ``(ck, cv, pos, lengths, enc_lengths)``: x is one
    token, its K/V are written into this layer's cache ck/cv (B, T, KV,
    dh) at ``pos`` in place, and both attentions take the decode kernel.
    Returns (x, (k, v)) with this call's self-attention K/V."""
    cd = L.COMPUTE_DTYPE
    p = L.fsdp_whole(p, "dec_blocks/", layer=True)
    h = L.copy_to_tp(L.layernorm(x, p["ln1"], p["ln1b"]).to(cd))
    q, (k, v) = _q(cfg, p, h), _kv(cfg, p, h)
    if cache is None:
        attn = ops.flash_attention(q, k, v, causal=True)
    else:
        ck, cv, pos, lengths, enc_lengths = cache
        ck[:, pos] = k[:, 0]
        cv[:, pos] = v[:, 0]
        attn = ops.decode_attention(q[:, 0], ck, cv, lengths)[:, None]
    x = x + _out(cfg, p, attn).to(x.dtype)
    # cross-attention: K/V from the encoder output, at every call
    hx = L.copy_to_tp(L.layernorm(x, p["ln_x"], p["ln_xb"]).to(cd))
    qx, (kx, vx) = _q(cfg, p, hx, "x_"), _kv(cfg, p, L.copy_to_tp(enc_out),
                                              "x_")
    if cache is None:
        ax = ops.flash_attention(qx, kx, vx, causal=False)
    else:
        ax = ops.decode_attention(qx[:, 0], kx, vx, enc_lengths)[:, None]
    x = x + _out(cfg, p, ax, "x_").to(x.dtype)
    h2 = L.copy_to_tp(L.layernorm(x, p["ln2"], p["ln2b"]).to(cd))
    return x + _mlp(cfg, p, h2).to(x.dtype), (k, v)


def _head(cfg, params, x):
    """Final layernorm and the tied embedding: f32 logits (the rank's
    vocabulary columns where the embedding is split)."""
    h = L.layernorm(x, params["dec_ln"], params["dec_lnb"]).to(L.COMPUTE_DTYPE)
    return L.head_logits(h, L.fsdp_leaf(params["embed"], "embed").T,
                         cfg.vocab_size)


def _decoder(cfg, params, tokens, enc_out, return_kv: bool, remat=False):
    """The decoder over whole sequences: (hidden (B, S, D), (k, v) each
    (L, B, S, KV, dh) or None)."""
    S = tokens.shape[1]
    pos_ids = torch.arange(S, device=tokens.device) % DEC_POS_ROWS
    x = L.embed_tokens(cfg, params, tokens) + params["dec_pos"][pos_ids][None]
    ks, vs = [], []
    for p in L.layer_views(params["dec_blocks"], cfg.num_layers):
        x, (k, v) = L.checkpointed(_dec_block, cfg, p, x, enc_out,
                                   remat=remat)
        if return_kv:
            ks.append(k)
            vs.append(v)
    return x, ((torch.stack(ks), torch.stack(vs)) if return_kv else None)


def forward(cfg, params, batch, *, remat=False):
    """Logits (B, S, V) f32 for batch["tokens"] (B, S) given
    batch["frames"] (B, T_enc, D)."""
    enc_out = encode(cfg, params, batch["frames"], remat=remat)
    x, _ = _decoder(cfg, params, batch["tokens"], enc_out, return_kv=False,
                    remat=remat)
    return _head(cfg, params, x)


def loss_fn(cfg, params, batch, *, remat=True):
    """Mean cross-entropy (with the z-loss) of the decoder's next tokens:
    the reference's training loss."""
    logits = forward(cfg, params, batch, remat=remat)
    return L.mean_xent(logits, batch["labels"], cfg.vocab_size)


# --- static decode -------------------------------------------------------------------

@dataclasses.dataclass
class WhisperState:
    k: torch.Tensor        # (L, B, T, KV, dh) self-attention cache
    v: torch.Tensor
    enc_out: torch.Tensor  # (B, T_enc, D) bf16
    pos: int               # next write offset (lockstep over the batch)


def init_decode_state(cfg, batch_size: int, cache_len: int,
                      dtype=None, device="cuda",
                      kv_expand: int = 1) -> WhisperState:
    """An empty cache of ``cache_len`` positions and a zero encoder
    output, in ``dtype`` (the compute dtype by default); ``kv_expand`` is
    accepted and unused, as in the reference. Under an installed mesh,
    the rank's KV heads."""
    dev = resolve_device(device)
    dtype = dtype or L.COMPUTE_DTYPE
    shape = (cfg.num_layers, batch_size, cache_len,
             cfg.num_kv_heads // L.tp_size(), cfg.head_dim)
    return WhisperState(
        k=torch.zeros(shape, dtype=dtype, device=dev),
        v=torch.zeros(shape, dtype=dtype, device=dev),
        enc_out=torch.zeros((batch_size, cfg.encoder.seq_len, cfg.d_model),
                            dtype=dtype, device=dev), pos=0)


def prefill(cfg, params, batch, cache_len: int, kv_expand: int = 1):
    """Encode the frames, run the full prompt, keep its self-attention
    K/V in a cache of ``cache_len`` positions; return the last position's
    logits (B, V) and the state (which keeps the encoder output).
    ``kv_expand`` is accepted and unused, as in the reference."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    enc_out = encode(cfg, params, batch["frames"])
    x, (k, v) = _decoder(cfg, params, tokens, enc_out, return_kv=True)
    pad = (0, 0, 0, 0, 0, cache_len - S)        # pad the position axis
    return _head(cfg, params, x[:, -1:])[:, 0], WhisperState(
        k=torch.nn.functional.pad(k, pad), v=torch.nn.functional.pad(v, pad),
        enc_out=enc_out, pos=S)


def decode_step(cfg, params, state: WhisperState, tokens):
    """One token for the whole batch, tokens (B,): self-attention over the
    cache prefix [0, pos] (the reference's ``kj <= pos`` mask) and cross-
    attention over every encoder frame, both through
    ``ops.decode_attention`` with lengths filled on the device. Writes
    the new K/V in place and advances ``state.pos``; returns (logits
    (B, V), state)."""
    B = tokens.shape[0]
    pos = state.pos
    dev = tokens.device
    lengths = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    enc_lengths = torch.full((B,), state.enc_out.shape[1],
                             dtype=torch.int32, device=dev)
    x = L.embed_tokens(cfg, params, tokens[:, None]) \
        + params["dec_pos"][pos % DEC_POS_ROWS][None, None]
    for i in range(cfg.num_layers):
        x, _ = _dec_block(cfg, _layer(params["dec_blocks"], i), x,
                          state.enc_out, (state.k[i], state.v[i], pos,
                                          lengths, enc_lengths))
    state.pos = pos + 1
    return _head(cfg, params, x)[:, 0], state
