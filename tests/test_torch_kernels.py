"""Plain versions of the port's kernels against the JAX reference.

Same inputs (numpy, seeded) through the JAX function and the port's
plain PyTorch version, in f32 within ``tests/test_kernels.py``'s f32
``TOL`` (rtol 1e-4, atol 2e-4: blocked-reduction order differences
against a one-shot einsum) and in bf16 within its bf16 tolerance (2e-2:
both round the f32 result to bf16 once). The Pallas kernels run in
interpret mode, as the reference's own tests run them on the CPU; the
packed-canvas ones only at batch sizes that are multiples of their
128-row tile, where the reference computes every row.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dequant as jdq
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro_torch.kernels import decode_attention as tdec
from repro_torch.kernels import dequant as tdq
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import packed_canvas as tpc
from repro_torch.models import layers as L

# the module, not the function that repro.kernels re-exports under its name
jdec = importlib.import_module("repro.kernels.decode_attention")

TOL = dict(rtol=1e-4, atol=2e-4)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)        # tiny CPU ops: no thread-pool contention
    yield
    torch.set_num_threads(n)


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


PAGED_SPLIT = [  # (B, KV, G, dh, P, page, M, lengths, splits, tile): the
    # paged kernel's split-T arithmetic at G 1, 2, 4, 7 and 12, ragged and
    # length-0 rows, chunks wholly past a row's length, and pages that do
    # and do not divide the tile
    (3, 2, 1, 16, 16, 4, 4, [5, 16, 0], 1, 8),
    (3, 2, 1, 16, 16, 4, 4, [5, 16, 0], 3, 8),
    (4, 2, 2, 32, 20, 8, 3, [1, 24, 9, 0], 2, 8),
    (2, 1, 4, 64, 12, 4, 5, [20, 7], 3, 16),
    (2, 2, 7, 16, 24, 8, 5, [40, 0], 3, 16),
    (3, 1, 7, 32, 30, 3, 9, [27, 1, 13], 2, 8),
    (2, 1, 12, 64, 14, 6, 6, [36, 17], 3, 16),
    (2, 2, 12, 16, 18, 16, 4, [0, 64], 1, 64),
]


@pytest.mark.parametrize("case", PAGED_SPLIT)
def test_paged_split_plain_matches_pallas_interpret(case):
    """The paged kernel's split-and-combine arithmetic in f32 against the
    reference's Pallas ``_paged_kernel`` in interpret mode and the plain
    paged decode, at any G."""
    B, KV, G, dh, P, page, M, lengths, splits, tile = case
    q, kp, vp, table, lens = _paged_case(7, B, KV, G, dh, P, page, M,
                                         lengths)
    want = np.asarray(jdec.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens), interpret=True))
    args = (torch.tensor(q).reshape(B, KV * G, dh),
            torch.tensor(kp.transpose(1, 2, 0, 3)),
            torch.tensor(vp.transpose(1, 2, 0, 3)), torch.tensor(table),
            torch.tensor(lens))
    got = ref.paged_decode_attention_split(*args, splits, tile=tile)
    np.testing.assert_allclose(got.reshape(B, KV, G, dh).numpy(), want,
                               **TOL)
    np.testing.assert_allclose(
        got.numpy(), ref.paged_decode_attention(*args).numpy(), **TOL)
    assert np.all(got.numpy()[lens == 0] == 0.0)


@pytest.mark.parametrize("case", PAGED_SPLIT[4:7])
def test_paged_split_plain_bf16(case):
    B, KV, G, dh, P, page, M, lengths, splits, tile = case
    q, kp, vp, table, lens = _paged_case(8, B, KV, G, dh, P, page, M,
                                         lengths)
    args = (torch.tensor(q).reshape(B, KV * G, dh).to(torch.bfloat16),
            torch.tensor(kp.transpose(1, 2, 0, 3)).to(torch.bfloat16),
            torch.tensor(vp.transpose(1, 2, 0, 3)).to(torch.bfloat16),
            torch.tensor(table), torch.tensor(lens))
    got = ref.paged_decode_attention_split(*args, splits, tile=tile)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(),
        ref.paged_decode_attention(*args).float().numpy(), **TOL_BF16)


def test_paged_decode_dispatch_rules():
    """CPU tensors take the plain version at any G (7 here); the kernel
    wrapper refuses them instead of quietly computing, and counts no
    launch; it has no G check left (a CPU tensor at G 7 is refused for
    its device, not its G)."""
    B, KV, G, dh, P, page, M = 2, 1, 7, 64, 6, 4, 2
    q, kp, vp, table, lens = _paged_case(9, B, KV, G, dh, P, page, M,
                                         [5, 8])
    qm = torch.tensor(q).reshape(B, KV * G, dh).to(torch.bfloat16)
    kpt, vpt = (torch.tensor(a).to(torch.bfloat16) for a in (kp, vp))
    tt, lt = torch.tensor(table), torch.tensor(lens)
    torch.testing.assert_close(
        ops.paged_decode_attention(qm, kpt, vpt, tt, lt),
        ref.paged_decode_attention(qm, kpt.permute(1, 2, 0, 3),
                                   vpt.permute(1, 2, 0, 3), tt, lt))
    with pytest.raises(ValueError, match="impl"):
        ops.paged_decode_attention(qm, kpt, vpt, tt, lt, impl="auto")
    n0 = tdec.paged_decode_attention.launches
    with pytest.raises(ValueError, match="CUDA"):
        tdec.paged_decode_attention(qm.view(B, KV, G, dh), kpt, vpt, tt, lt)
    with pytest.raises(ValueError, match="CUDA"):
        tdec.paged_decode_attention(qm.view(B, KV, G, dh), kpt, vpt, tt, lt,
                                    splits=3)
    assert tdec.paged_decode_attention.launches == n0


DENSE = [  # (B, KV, G, dh, T, bt, lengths): ragged and length-0 rows, and
    # T = 77, 150: off the CUDA kernel's 64-token tile (the Pallas kernel
    # runs at a tile bt that divides T)
    (3, 2, 1, 64, 96, 32, [96, 0, 37]),
    (2, 2, 2, 128, 77, 77, [77, 5]),
    (4, 1, 4, 64, 150, 50, [0, 1, 149, 150]),
    (2, 2, 8, 128, 64, 64, [63, 64]),
]


def _dense_case(seed, B, KV, G, dh, T, lengths):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, KV * G, dh), _rand(rng, B, T, KV, dh),
            _rand(rng, B, T, KV, dh), np.asarray(lengths, np.int32))


@pytest.mark.parametrize("case", DENSE)
def test_decode_plain_matches_pallas_interpret(case):
    """The plain version in model layout against the Pallas kernel
    (q (B, KV, G, dh), k/v (B, KV, T, dh)) in interpret mode."""
    B, KV, G, dh, T, bt, lengths = case
    q, k, v, lens = _dense_case(2, B, KV, G, dh, T, lengths)
    want = np.asarray(jdec.decode_attention(
        jnp.asarray(q.reshape(B, KV, G, dh)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(lens), bt=bt,
        interpret=True))
    got = ops.decode_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), torch.tensor(lens))
    np.testing.assert_allclose(got.reshape(B, KV, G, dh).numpy(), want,
                               **TOL)
    assert np.all(got.numpy()[lens == 0] == 0.0)   # the flush guard


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", DENSE)
def test_decode_plain_matches_jax_ref(case, dtype):
    B, KV, G, dh, T, bt, lengths = case
    q, k, v, lens = _dense_case(3, B, KV, G, dh, T, lengths)
    jdt, tdt, tol = ((jnp.float32, torch.float32, TOL) if dtype == "f32"
                     else (jnp.bfloat16, torch.bfloat16, TOL_BF16))
    want = np.asarray(jref.decode_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(lens)),
        np.float32)
    got = ops.decode_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                               torch.tensor(lens), impl="ref")
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


SPLIT = [  # (B, KV, G, dh, T, bt, lengths, splits, tile): the split-T
    # arithmetic at splits 1, 3, 7 with T off the chunk boundary, length-0
    # rows, lengths past T, chunks wholly past T, and G in {1, 3, 7, 12, 16}
    (3, 2, 1, 16, 77, 77, [77, 0, 40], 1, 16),
    (3, 2, 1, 16, 77, 77, [77, 0, 40], 3, 16),
    (2, 1, 3, 32, 150, 50, [150, 1], 3, 16),
    (2, 2, 7, 16, 100, 100, [300, 0], 7, 16),
    (2, 1, 12, 32, 96, 96, [96, 33], 7, 8),
    (2, 1, 16, 16, 64, 64, [0, 64], 3, 64),
    (1, 1, 7, 64, 130, 65, [129], 7, 64),
]


@pytest.mark.parametrize("case", SPLIT)
def test_decode_split_plain_matches_plain_and_pallas(case):
    """The dense kernel's split-and-combine arithmetic (per-chunk partials,
    log-sum-exp merge, empty chunks with l = 0) in f32 against the plain
    decode and the Pallas kernel in interpret mode."""
    B, KV, G, dh, T, bt, lengths, splits, tile = case
    q, k, v, lens = _dense_case(5, B, KV, G, dh, T, lengths)
    got = ref.decode_attention_split(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), torch.tensor(lens),
                                     splits, tile=tile)
    want = ref.decode_attention(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), torch.tensor(lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    pallas = np.asarray(jdec.decode_attention(
        jnp.asarray(q.reshape(B, KV, G, dh)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)), jnp.asarray(lens), bt=bt,
        interpret=True))
    np.testing.assert_allclose(got.reshape(B, KV, G, dh).numpy(), pallas,
                               **TOL)
    assert np.all(got.numpy()[lens == 0] == 0.0)


@pytest.mark.parametrize("case", SPLIT)
def test_decode_split_plain_bf16(case):
    B, KV, G, dh, T, bt, lengths, splits, tile = case
    q, k, v, lens = _dense_case(6, B, KV, G, dh, T, lengths)
    args = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = ref.decode_attention_split(*args, torch.tensor(lens), splits,
                                     tile=tile)
    assert got.dtype == torch.bfloat16
    want = ref.decode_attention(*args, torch.tensor(lens))
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               **TOL_BF16)


def test_split_plan_covers_t_in_whole_tiles():
    """Every plan covers T with whole 64-token tiles and no chunk wholly
    past T; a grid covering half the SMs or more is not split, a smaller
    one is; ``splits`` overrides the count."""
    for B, KV, G, T in [(8, 16, 1, 640), (8, 6, 1, 1500), (8, 32, 1, 640),
                        (8, 8, 4, 640), (8, 6, 1, 288), (1, 1, 1, 0),
                        (2, 4, 7, 1), (1, 2, 20, 4097), (64, 8, 1, 100)]:
        splits, chunk = tdec.split_plan(B, KV, G, T)
        assert chunk % tdec.SPLIT_TILE == 0 and splits * chunk >= T
        assert (splits - 1) * chunk < max(T, 1)
        if 2 * B * KV * -(-G // tdec.QROWS) >= 132:
            assert splits == 1
    assert tdec.split_plan(8, 16, 1, 640) == (1, 640)     # olmoe: 128 blocks
    assert tdec.split_plan(8, 8, 4, 640) == (3, 256)      # 64 blocks
    assert tdec.split_plan(8, 6, 1, 1500) == (6, 256)     # whisper cross
    assert tdec.split_plan(8, 16, 1, 640, splits=1) == (1, 640)
    assert tdec.split_plan(8, 16, 1, 640, splits=100) == (10, 64)
    # a cap: chunks of at most 4 tiles, whatever the grid
    cap = 4
    assert tdec.split_plan(8, 32, 1, 2048, max_tiles=cap) == (8, 256)
    assert tdec.split_plan(8, 32, 1, 640, max_tiles=cap) == (3, 256)
    assert tdec.split_plan(8, 4, 7, 2048, max_tiles=cap) == (8, 256)
    assert tdec.split_plan(8, 32, 1, 64, max_tiles=cap) == (1, 64)
    assert tdec.split_plan(8, 32, 1, 2048, splits=1, max_tiles=cap) == \
        (1, 2048)
    # the paged entry's at the engine's table (40 pages of 16): 4 chunks
    assert tdec.split_plan(8, 32, 1, 640,
                           max_tiles=tdec.PAGED_CHUNK_TILES) == (4, 192)


def test_decode_attention_dispatch_rules():
    """CPU tensors take the plain version; the kernel wrapper refuses
    them instead of quietly computing, and counts no launch."""
    rng = np.random.default_rng(4)
    q = torch.tensor(_rand(rng, 2, 4, 64)).to(torch.bfloat16)
    k = torch.tensor(_rand(rng, 2, 10, 2, 64)).to(torch.bfloat16)
    lens = torch.tensor([10, 3], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q, k, k, lens),
                               ref.decode_attention(q, k, k, lens))
    with pytest.raises(ValueError, match="impl"):
        ops.decode_attention(q, k, k, lens, impl="auto")
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q.view(2, 2, 2, 64), k.transpose(1, 2),
                              k.transpose(1, 2), lens)
    assert tdec.decode_attention.launches == 0


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


# --- packed canvas and its dequant twin ----------------------------------------

# (kb, cb) cover with runs of 1, 3, 5 and 2 blocks, given unsorted
CANVAS_BLOCKS = np.asarray([(4, 1), (0, 0), (2, 1), (5, 2), (0, 1), (1, 2),
                            (3, 2), (0, 2), (2, 2), (5, 3), (1, 3)])
R_CANVAS, C_CANVAS = 6 * 128, 4 * 128


def _canvas(seed, B, scale=1.0):
    rng = np.random.default_rng(seed)
    meta, _ = tpc.build_block_meta(CANVAS_BLOCKS)
    x = _rand(rng, B, R_CANVAS)
    w = _rand(rng, len(CANVAS_BLOCKS), 128, 128) * np.float32(scale)
    bias = _rand(rng, C_CANVAS)
    res = _rand(rng, B, C_CANVAS)
    return meta, x, w, bias, res


def _to(dtype_name, *arrays):
    """numpy f32 -> (jax, torch) pairs holding the same values."""
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    return [(jnp.asarray(a, jdt), torch.tensor(a).to(tdt)) for a in arrays]


EPILOGUES = [  # (bias, residual, activation)
    (False, False, None), (True, False, None), (False, True, None),
    (True, True, "none"), (True, True, "relu"), (True, False, "silu"),
    (False, True, "gelu"), (True, True, "gelu")]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("with_bias,with_res,activation", EPILOGUES)
def test_packed_canvas_plain_matches_pallas_interpret(dtype, with_bias,
                                                      with_res, activation):
    meta, x, w, bias, res = _canvas(6, 128, scale=0.1)
    (jx, tx), (jw, tw), (jb, tb), (jr, tr) = _to(dtype, x, w, bias, res)
    want = jops.packed_canvas_matmul(
        jx, jw, jnp.asarray(meta), impl="interpret",
        bias=jb if with_bias else None, residual=jr if with_res else None,
        activation=activation)
    got = ops.packed_canvas_matmul(
        tx, tw, meta, bias=tb if with_bias else None,
        residual=tr if with_res else None, activation=activation)
    assert got.dtype == tx.dtype and got.shape == (128, C_CANVAS)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "f32" else TOL_BF16))


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("epilogue", [False, True])
def test_dequant_plain_matches_pallas_interpret(precision, dtype, epilogue):
    meta, x, w, bias, res = _canvas(7, 128, scale=0.1)
    jq, js = jdq.quantize_blocks(jnp.asarray(w), precision)
    tq, ts = ref.quantize_blocks(torch.tensor(w), precision)
    (jx, tx), (jb, tb), (jr, tr) = _to(dtype, x, bias, res)
    kw = dict(activation="silu") if epilogue else {}
    want = jops.packed_canvas_matmul_dq(
        jx, jq, js, jnp.asarray(meta), precision=precision,
        impl="interpret", bias=jb if epilogue else None,
        residual=jr if epilogue else None, **kw)
    got = ops.packed_canvas_matmul_dq(
        tx, tq, ts, meta, precision=precision,
        bias=tb if epilogue else None, residual=tr if epilogue else None,
        **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               **(TOL if dtype == "f32" else TOL_BF16))


def _dense(meta, w):
    """The virtual plane in f64 from blocks, independently of the port."""
    wd = np.zeros((R_CANVAS, C_CANVAS))
    for g in range(meta.shape[1]):
        kb, cb = meta[0, g], meta[1, g]
        wd[kb * 128:(kb + 1) * 128, cb * 128:(cb + 1) * 128] = w[g]
    return wd


@pytest.mark.parametrize("B", [200, 1, 130])
def test_packed_canvas_plain_at_ragged_batch_matches_dense_oracle(B):
    """Every row is computed at any B (the reference's interpret path
    leaves rows past the last full 128-row tile unwritten, so the port is
    held against the dense product here)."""
    meta, x, w, bias, res = _canvas(8, B)
    wd = _dense(meta, w)
    y = x.astype(np.float64) @ wd
    got = ops.packed_canvas_matmul(torch.tensor(x), torch.tensor(w), meta)
    np.testing.assert_allclose(got.numpy(), y, **TOL)
    got = ops.packed_canvas_matmul(
        torch.tensor(x), torch.tensor(w), meta, bias=torch.tensor(bias),
        residual=torch.tensor(res), activation="relu")
    np.testing.assert_allclose(got.numpy(), np.maximum(y + bias, 0) + res,
                               **TOL)
    for precision in ("int8", "int4"):
        q, s = ref.quantize_blocks(torch.tensor(w), precision)
        wq = _dense(meta, ref.dequantize_blocks(q, s, precision).numpy())
        got = ops.packed_canvas_matmul_dq(torch.tensor(x), q, s, meta,
                                          precision=precision)
        np.testing.assert_allclose(got.numpy(), x.astype(np.float64) @ wq,
                                   **TOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_canvas_oracles_match_jax_ref(dtype):
    meta, x, w, _, _ = _canvas(9, 16)
    (jx, tx), (jw, tw) = _to(dtype, x, w)
    jd = jref.blocks_to_dense(jw, meta, R_CANVAS, C_CANVAS)
    td = ref.blocks_to_dense(tw, meta, R_CANVAS, C_CANVAS)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(
        ref.packed_canvas(tx, td.to(tx.dtype)).float().numpy(),
        np.asarray(jref.packed_canvas(jx, jd.astype(jx.dtype)), np.float32),
        **(TOL if dtype == "f32" else TOL_BF16))


# --- the kernels' arithmetic order: per-block scale, chunks in plan order -------
#
# The CUDA routines sum each block's products in f32, multiply a quantized
# block's f32 sum by its columns' scales once, add a split run's chunks in
# plan order, then the runs. ``ref.packed_canvas_blocks`` / ``packed_canvas_dq``
# with a plan's ``chunk_off`` is that order; it is held here against the
# Pallas kernels (per-weight dequant, one accumulator a run). x and the fp
# blocks are rounded to bf16 first (the tensor cores' inputs) and computed
# in f32: the products are exact on both sides, so they differ by summation
# order and the scale's place only, within the f32 TOL.


def _bf16_grid(*arrays):
    return [np.asarray(torch.tensor(a).bfloat16().float()) for a in arrays]


def _chunks(meta, sms):
    """A split plan's block offsets for the test layout, one batch tile,
    on a card of ``sms`` SMs (5: runs of 1, 3, 5, 2 cut into at most 2)."""
    runs = tpc.canvas_runs(meta, "cpu")
    return tpc.split_plan(runs.cb_host, 1, sms)[0]


def _order(tx, tw, meta, precision, chunk_off, **epi):
    runs = tpc.canvas_runs(meta, "cpu")
    if precision is None:
        return ref.packed_canvas_blocks(tx, tw, runs.meta, runs.c_blocks,
                                        chunk_off=chunk_off, **epi)
    q, s = ref.quantize_blocks(tw, precision)
    return ref.packed_canvas_dq(tx, q, s, runs.meta, runs.c_blocks,
                                precision, chunk_off=chunk_off, **epi)


@pytest.mark.parametrize("precision,epilogue", [
    (None, False), ("int8", True), ("int4", False)])
def test_kernel_order_matches_pallas_interpret(precision, epilogue):
    """Case 1, B = 128 (the reference's tile: every row written)."""
    meta, x, w, bias, res = _canvas(14, 128, scale=0.1)
    x, w = _bf16_grid(x, w)
    epi = dict(bias=bias, residual=res, activation="gelu") if epilogue else {}
    jepi = {k: jnp.asarray(v) if k != "activation" else v
            for k, v in epi.items()}
    tepi = {k: torch.tensor(v) if k != "activation" else v
            for k, v in epi.items()}
    if precision is None:
        want = jops.packed_canvas_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(meta), impl="interpret",
                                         **jepi)
    else:
        jq, js = jdq.quantize_blocks(jnp.asarray(w), precision)
        want = jops.packed_canvas_matmul_dq(
            jnp.asarray(x), jq, js, jnp.asarray(meta), precision=precision,
            impl="interpret", **jepi)
    got = _order(torch.tensor(x), torch.tensor(w), meta, precision,
                 _chunks(meta, 5), **tepi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.mark.parametrize("B", [1, 9, 200])
def test_kernel_order_matches_f64_oracle(B):
    """Case 2, at batches off the reference's tile (it leaves rows past its
    last full tile unwritten): the order against the dense plane in f64,
    fp, int8 and int4."""
    meta, x, w, _, _ = _canvas(15, B, scale=0.1)
    x, w = _bf16_grid(x, w)
    chunk_off = _chunks(meta, 5)
    for precision in (None, "int8", "int4"):
        wf = w if precision is None else ref.dequantize_blocks(
            *ref.quantize_blocks(torch.tensor(w), precision),
            precision).double().numpy()
        want = x.astype(np.float64) @ _dense(meta, wf)
        got = _order(torch.tensor(x), torch.tensor(w), meta, precision,
                     chunk_off)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("sms", [4, 5, 132])
def test_split_plan_chunks_against_whole_runs(sms):
    """Case 3: a plan's chunks partition each run in block order, evenly
    and in launch order longest first; whole runs while the runs give
    every SM a CUDA block; summed in plan order they give the whole runs'
    result (f32 TOL: order only)."""
    meta, x, w, _, _ = _canvas(16, 9, scale=0.1)
    cb_start = tpc.canvas_runs(meta, "cpu").cb_host
    off, chunk_cb, cb_chunk, order = tpc.split_plan(cb_start, 1, sms)
    lengths = np.diff(cb_start)
    if len(lengths) >= sms:
        assert off.tolist() == cb_start.tolist()
    cap = max(1, -(-int(cb_start[-1]) // (tpc.CHUNKS_PER_SM * sms)))
    assert off[0] == 0 and off[-1] == cb_start[-1]
    for cb, n in enumerate(lengths):
        first, last = cb_chunk[cb], cb_chunk[cb + 1]
        assert off[first] == cb_start[cb] and off[last] == cb_start[cb + 1]
        assert np.all(chunk_cb[first:last] == cb)
        sizes = np.diff(off[first:last + 1])
        assert sizes.min() >= 1 and sizes.max() - sizes.min() <= 1
        assert len(lengths) >= sms or sizes.max() <= cap
    sizes = np.diff(off)
    assert sorted(order.tolist()) == list(range(len(sizes)))
    assert np.all(np.diff(sizes[order]) <= 0)
    tx, tw = torch.tensor(x), torch.tensor(w)
    for precision in (None, "int8"):
        np.testing.assert_allclose(
            _order(tx, tw, meta, precision, off).numpy(),
            _order(tx, tw, meta, precision, None).numpy(), **TOL)


def test_batch_tile_is_the_smallest_instance_that_holds_b():
    tc = [tpc.batch_tile(B, 128, True) for B in (1, 8, 9, 16, 17, 33, 64,
                                                 65, 128, 129, 200)]
    assert tc == [8, 8, 16, 16, 32, 64, 64, 128, 128, 128, 128]
    assert tpc.batch_tile(200, 16, True) == 16          # bb caps the tile
    fma = [tpc.batch_tile(B, 128, False) for B in (1, 32, 33, 200)]
    assert fma == [8, 8, 64, 64]


def _quant_inputs():
    """Random blocks plus columns that probe the encoding's edges: exact
    halves (round half to even), the clip range, an all-zero column."""
    rng = np.random.default_rng(10)
    w = _rand(rng, 3, 128, 128)
    w[0, :, 0] = 0.0
    w[0, :4, 1] = [127.0, 2.5, -3.5, 0.5]      # int8 scale 1: 2, -4, 0
    w[0, 4:, 1] = 0.0
    w[1, :4, 2] = [7.0, -7.5, 2.5, -0.5]       # int4 scale 1: -8 clip
    w[1, 4:, 2] = 0.0
    return w


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_blocks_bit_identical_to_jax(precision, dtype):
    ((jw, tw),) = _to(dtype, _quant_inputs())
    jq, js = jdq.quantize_blocks(jw, precision)
    tq, ts = ref.quantize_blocks(tw, precision)
    assert str(tq.dtype).split(".")[-1] == str(jq.dtype)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        ref.dequantize_blocks(tq, ts, precision).numpy(),
        np.asarray(jdq.dequantize_blocks(jq, js, precision)))


@pytest.mark.parametrize("precision", ["int8", "int4"])
def test_quantize_tensor_and_fake_quant_match_jax(precision):
    rng = np.random.default_rng(11)
    w = _rand(rng, 48, 40)
    jq, js = jdq.quantize_tensor(jnp.asarray(w), precision)
    tq, ts = tdq.quantize_tensor(torch.tensor(w), precision)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tdq.fake_quant(torch.tensor(w), precision).numpy(),
        np.asarray(jdq.fake_quant(jnp.asarray(w), precision)))
    assert tdq.fake_quant(torch.tensor(w), "fp").equal(torch.tensor(w))


def test_canvas_runs_cached_and_no_gap_contract():
    meta, _, _, _, _ = _canvas(12, 4)
    runs = tpc.canvas_runs(meta, "cpu")
    assert runs is tpc.canvas_runs(meta, "cpu")          # once per layout
    assert runs.c_blocks == 4 and runs.kb_end == 6
    assert runs.cb_start.tolist() == [0, 1, 4, 9, 11]
    t = torch.tensor(meta)
    assert tpc.canvas_runs(t, "cpu").cb_start.tolist() == [0, 1, 4, 9, 11]
    gap, _ = tpc.build_block_meta(np.asarray([(0, 0), (1, 2)]))   # no cb 1
    with pytest.raises(AssertionError, match="no-gap"):
        tpc.canvas_runs(gap, "cpu")


def test_canvas_dispatch_rules():
    """A CPU tensor takes the plain version; the kernel wrappers refuse
    CPU tensors; bad activations and precisions raise."""
    meta, x, w, bias, _ = _canvas(13, 8)
    tx, tw = torch.tensor(x), torch.tensor(w)
    torch.testing.assert_close(
        ops.packed_canvas_matmul(tx, tw, meta),
        ops.packed_canvas_matmul(tx, tw, meta, impl="ref"))
    with pytest.raises(ValueError, match="activation"):
        ops.packed_canvas_matmul(tx, tw, meta, activation="tanh")
    with pytest.raises(ValueError, match="impl"):
        ops.packed_canvas_matmul(tx, tw, meta, impl="interpret")
    with pytest.raises(ValueError, match="precision"):
        ref.quantize_blocks(tw, "int2")
    q, s = ref.quantize_blocks(tw, "int4")
    with pytest.raises(ValueError, match="CUDA"):
        tpc.packed_canvas_matmul(tx, tw, meta)
    with pytest.raises(ValueError, match="CUDA"):
        tpc.packed_canvas_matmul(tx, tw, meta, bias=torch.tensor(bias))
    with pytest.raises(ValueError, match="CUDA"):
        tdq.packed_canvas_matmul_dq(tx, q, s, meta, precision="int4")
    with pytest.raises(ValueError, match="CUDA"):
        tdq.packed_canvas_matmul_dq(tx, q, s, meta, precision="int4",
                                    activation="gelu")
    assert tpc._packed_canvas_matmul.launches == 0
    assert tpc._packed_canvas_epilogue.launches == 0
    assert tdq._matmul_dq.launches == 0
    assert tdq._matmul_dq_epilogue.launches == 0
