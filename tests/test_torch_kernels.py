"""Plain versions of the port's kernels against the JAX reference.

Same inputs (numpy, seeded) through the JAX function and the port's
plain PyTorch version, in f32 within ``tests/test_kernels.py``'s f32
``TOL`` (rtol 1e-4, atol 2e-4: blocked-reduction order differences
against a one-shot einsum). The Pallas paged-decode kernel runs in
interpret mode, as the reference's own tests run it on the CPU.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

# the module, not the function that repro.kernels re-exports under its name
jdec = importlib.import_module("repro.kernels.decode_attention")

TOL = dict(rtol=1e-4, atol=2e-4)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _paged_case(seed, B, KV, G, dh, P, page, M, lengths):
    rng = np.random.default_rng(seed)
    q = _rand(rng, B, KV, G, dh)
    kp = _rand(rng, KV, P, page, dh)
    vp = _rand(rng, KV, P, page, dh)
    # distinct live pages per row; dead slots point at the trash page 0
    table = np.zeros((B, M), np.int32)
    perm = rng.permutation(np.arange(1, P))
    for b in range(B):
        n = -(-int(lengths[b]) // page)
        table[b, :n] = perm[b * M:b * M + n]
    return q, kp, vp, table, np.asarray(lengths, np.int32)


PAGED = [  # (B, KV, G, dh, P, page, M, lengths): ragged and length-0 rows
    (3, 2, 1, 16, 16, 4, 4, [5, 16, 0]),
    (4, 2, 2, 32, 20, 8, 3, [1, 24, 9, 0]),
    (2, 1, 4, 16, 12, 4, 5, [20, 7]),
]


@pytest.mark.parametrize("case", PAGED)
def test_paged_decode_plain_matches_pallas_interpret(case):
    B, KV, G, dh, P, page, M, lengths = case
    q, kp, vp, table, lens = _paged_case(0, *case)
    want = np.asarray(jdec.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), interpret=True))
    got = ops.paged_decode_attention(
        torch.tensor(q).reshape(B, KV * G, dh), torch.tensor(kp),
        torch.tensor(vp), torch.tensor(table), torch.tensor(lens))
    np.testing.assert_allclose(got.reshape(B, KV, G, dh).numpy(), want,
                               **TOL)
    assert np.all(got.numpy()[lens == 0] == 0.0)   # the flush guard


@pytest.mark.parametrize("case", PAGED)
def test_paged_decode_plain_matches_jax_ref(case):
    B, KV, G, dh, P, page, M, lengths = case
    q, kp, vp, table, lens = _paged_case(1, *case)
    qm = q.reshape(B, KV * G, dh)
    kt, vt = kp.transpose(1, 2, 0, 3), vp.transpose(1, 2, 0, 3)
    want = np.asarray(jref.paged_decode_attention(
        jnp.asarray(qm), jnp.asarray(kt), jnp.asarray(vt),
        jnp.asarray(table), jnp.asarray(lens)))
    got = ref.paged_decode_attention(
        torch.tensor(qm), torch.tensor(kt), torch.tensor(vt),
        torch.tensor(table), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


ATTN = [  # (B, S, T, H, KV, causal, window): aligned and unaligned S/T
    (2, 64, 64, 4, 2, True, 0),
    (1, 37, 37, 2, 2, True, 0),
    (1, 64, 130, 4, 1, True, 0),
    (2, 13, 40, 4, 2, False, 0),
    (1, 48, 48, 2, 1, True, 16),
    (1, 30, 77, 4, 4, True, 9),
]


@pytest.mark.parametrize("case", ATTN)
def test_mha_plain_matches_jax_ref(case):
    B, S, T, H, KV, causal, window = case
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, B, S, H, 16), _rand(rng, B, T, KV, 16), \
        _rand(rng, B, T, KV, 16)
    want = np.asarray(jref.mha_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_chunked_attention_matches_jax(causal, window):
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 64, 4, 16), _rand(rng, 2, 64, 2, 16), \
        _rand(rng, 2, 64, 2, 16)
    want = np.asarray(JL.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_chunk=16))
    got = L.chunked_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=causal, window=window,
                              q_chunk=16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_gqa_attention_with_masks_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = _rand(rng, 2, 24, 4, 16), _rand(rng, 2, 24, 2, 16), \
        _rand(rng, 2, 24, 2, 16)
    lens = np.asarray([24, 11], np.int32)
    for jm, tm in (
            (JL.causal_mask(24, 24), L.causal_mask(24, 24)),
            (JL.window_mask(24, 24, 5), L.window_mask(24, 24, 5)),
            (JL.valid_mask_from_length(24, jnp.asarray(lens)),
             L.valid_mask_from_length(24, torch.tensor(lens)))):
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        want = np.asarray(JL.gqa_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), mask=jm))
        got = L.gqa_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), mask=tm)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ops_dispatch_rules():
    """A CPU tensor takes the plain version, ``impl="ref"`` is allowed,
    anything else raises; the kernel wrappers refuse CPU tensors instead
    of quietly computing."""
    rng = np.random.default_rng(5)
    q = torch.tensor(_rand(rng, 1, 8, 2, 64)).to(torch.bfloat16)
    k = torch.tensor(_rand(rng, 1, 8, 2, 64)).to(torch.bfloat16)
    got = ops.flash_attention(q, k, k)
    torch.testing.assert_close(got, ops.flash_attention(q, k, k, impl="ref"))
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, k, k, impl="auto")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            k.transpose(1, 2))
    kp = torch.zeros((2, 3, 4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.paged_decode_attention(
            q[:, :1].reshape(1, 2, 1, 64).contiguous(), kp, kp,
            torch.zeros((1, 2), dtype=torch.int32),
            torch.ones((1,), dtype=torch.int32))
    assert tfa.flash_attention.launches == 0
    assert tdec.paged_decode_attention.launches == 0
