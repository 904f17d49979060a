"""Model building blocks of the port (the main-path subset of
``repro.models.layers``), in PyTorch.

Conventions kept from the reference: compute in bf16, norms and biases
in f32 at use, logits in f32; shapes polymorphic over batch and sequence.
The paged-cache writers update the pool in place (the reference donates
it).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32
NEG_INF = -1e30


# --- paged KV cache ---------------------------------------------------------------
# Page 0 of every pool is the pager's trash page: dead table slots and
# inactive decode slots point there, and attention lengths gate it out.

def paged_cache_init(num_layers: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int, dtype=COMPUTE_DTYPE,
                     device="cpu"):
    """(k_pages, v_pages), each (L, KV, P, page, dh), head-major so the
    decode kernel reads a layer's pool without relayout."""
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

def trunc_normal_(t, gen, std=0.02):
    """Fill ``t`` in place with std * N(0, 1) truncated to [-2, 2]."""
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


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


# --- multi-step decode fusion ----------------------------------------------------

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
    slot's budget) are 0.
    """
    B = pending.shape[0]
    pt = torch.where(mask[:, None], page_table, 0)
    out = torch.zeros((hmax, B), dtype=torch.int32, device=pending.device)
    for i in range(h):
        live = mask & (remaining > 0)
        toks = torch.where(live, pending, 0)
        lens = torch.where(live, lengths, 0)
        logits = step_fn(toks, pt, lens, live)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if teacher is not None:
            nxt = teacher[i]
        pending.copy_(torch.where(live, nxt, pending))
        out[i] = torch.where(live, nxt, 0)
        took = live.to(torch.int32)
        lengths.add_(took)
        remaining.sub_(took)
    return out
