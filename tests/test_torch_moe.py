"""The port's MoE path against the JAX package: configs, the grouped
expert GEMM's plain version, ``moe_ffn``, and the deepseek MLA-MoE model
(static and paged prefill/decode, fused horizon).

Inputs come from numpy seeds; weights from the reference's
``init_params`` converted by ``repro_torch.convert.params_from_jax``.
Tolerances: the kernel's plain version and ``moe_ffn`` in f32 within
``tests/test_kernels.py``'s f32 TOL (rtol 1e-4, atol 2e-4: summation
order only). Model logits and latents run in bf16 compute like the
reference, which rounds at other places in XLA than PyTorch does; they
agree within a few bf16 quanta: rtol = atol = 4e-2 (2^-8 relative a
rounding, compounded over two layers; logits are of order 1-4). Routing
keep masks must match exactly, and greedy tokens exactly or, at a bf16
tie of the logits, within the repository's greedy gap (0.0625).
Routing near a tie follows bf16 rounding, where the reference's compiled
run and its op-by-op run (``jax.disable_jit``) can disagree with each
other; the paged paths are held against both (``close_to_reference``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import both_runs, close_to_reference
from repro.configs import get_config as jget
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import get_model as jget_model
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import moe as M

TOL32 = dict(rtol=1e-4, atol=2e-4)
TOL_BF16 = dict(rtol=4e-2, atol=4e-2)
GREEDY_GAP = 0.0625
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, cfg, params_from_jax(jax.tree.map(np.asarray, jp),
                                          device="cpu")


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _np(t):
    return t.float().numpy()


# --- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, "olmoe-1b-7b"])
def test_config_matches_reference(arch):
    """Full and reduced configs name the reference's shapes, MoE and MLA
    included (4 experts, top-2, d_ff_expert 32, one shared expert where
    the arch has any, the arch's capacity factor; MLA r 32, 16/8/16)."""
    for j, t in ((jget(arch), get_config(arch)),
                 (jget(arch).reduced(), get_config(arch).reduced())):
        for f in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size", "norm",
                  "qkv_bias", "tie_embeddings", "rope_theta"):
            assert getattr(j, f) == getattr(t, f), f
        assert dataclasses.asdict(j.moe) == dataclasses.asdict(t.moe)
        assert (j.mla is None) == (t.mla is None)
        if j.mla is not None:
            assert dataclasses.asdict(j.mla) == dataclasses.asdict(t.mla)


# --- grouped expert GEMM (plain version) -----------------------------------------

GROUPED = [(4, 128, 64, 128), (4, 5, 64, 128), (3, 60, 40, 24)]


@pytest.mark.parametrize("E,C,D,F", GROUPED)
def test_grouped_mvm_plain_matches_pallas_interpret(E, C, D, F):
    rng = np.random.default_rng(E * C)
    x, w = _rand(rng, E, C, D), _rand(rng, E, D, F)
    want = np.asarray(jops.grouped_mvm(jnp.asarray(x), jnp.asarray(w),
                                       impl="interpret"))
    np.testing.assert_allclose(
        _np(ref.grouped_mvm(torch.tensor(x), torch.tensor(w))), want,
        **TOL32)
    np.testing.assert_allclose(
        _np(ops.grouped_mvm(torch.tensor(x), torch.tensor(w), impl="ref")),
        np.asarray(jref.grouped_mvm(jnp.asarray(x), jnp.asarray(w))),
        **TOL32)


@pytest.mark.parametrize("E,C,D,F", GROUPED)
def test_moe_expert_ffn_plain_matches_pallas_interpret(E, C, D, F):
    rng = np.random.default_rng(E + C)
    xe = _rand(rng, E, C, D)
    wg, wu, wd = _rand(rng, E, D, F), _rand(rng, E, D, F), \
        _rand(rng, E, F, D)
    want = np.asarray(jops.moe_expert_ffn(
        *(jnp.asarray(a) for a in (xe, wg, wu, wd)), impl="interpret"))
    got = ops.moe_expert_ffn(*(torch.tensor(a) for a in (xe, wg, wu, wd)),
                             impl="ref")
    np.testing.assert_allclose(_np(got), want, **TOL32)


def test_grouped_mvm_rounds_once_to_x_dtype():
    """bf16 in: f32 products and sums, one rounding at the end."""
    rng = np.random.default_rng(3)
    x = torch.tensor(_rand(rng, 2, 3, 40)).to(torch.bfloat16)
    w = torch.tensor(_rand(rng, 2, 40, 16)).to(torch.bfloat16)
    got = ops.grouped_mvm(x, w)
    assert got.dtype == torch.bfloat16
    want = torch.einsum("ecd,edf->ecf", x.double(), w.double())
    assert torch.equal(got, want.float().to(torch.bfloat16))


GROUPED_ROWS = [  # (E, C, D, F, rows): an expert with none, one full,
    # ragged ones, C off every tile
    (4, 8, 64, 128, [3, 0, 8, 1]),
    (3, 5, 40, 24, [5, 0, 2]),
    (4, 128, 64, 128, [128, 0, 77, 1]),
]


@pytest.mark.parametrize("E,C,D,F,rows", GROUPED_ROWS)
def test_grouped_mvm_rows_plain_matches_pallas_interpret(E, C, D, F, rows):
    """x laid out as ``moe_ffn`` lays it out (rows past each expert's count
    are zeros): the plain version told the counts equals the reference's
    Pallas kernel in interpret mode (which computes every row) and itself
    without counts, bit for bit. Where x is not zero past a count, those
    output rows still come out zero."""
    rng = np.random.default_rng(E * C + D)
    x, w = _rand(rng, E, C, D), _rand(rng, E, D, F)
    dead = np.arange(C)[None, :] >= np.asarray(rows)[:, None]     # (E, C)
    x[dead] = 0.0
    want = np.asarray(jops.grouped_mvm(jnp.asarray(x), jnp.asarray(w),
                                       impl="interpret"))
    tr = torch.tensor(rows, dtype=torch.int32)
    got = ref.grouped_mvm(torch.tensor(x), torch.tensor(w), tr)
    np.testing.assert_allclose(_np(got), want, **TOL32)
    assert torch.equal(got, ref.grouped_mvm(torch.tensor(x), torch.tensor(w)))
    full = _rand(rng, E, C, D)
    got = ops.grouped_mvm(torch.tensor(full), torch.tensor(w), tr,
                          impl="ref")
    assert torch.all(got[torch.tensor(dead)] == 0)
    np.testing.assert_allclose(_np(got)[~dead],
                               np.einsum("ecd,edf->ecf", full, w)[~dead],
                               **TOL32)


# --- moe_ffn ----------------------------------------------------------------------


def _moe_case(seed, N, D=64):
    jcfg = jget(ARCH).reduced()
    jp = JL.init_moe_params(jax.random.PRNGKey(seed), jcfg, D)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = _rand(np.random.default_rng(seed), N, D)
    return jcfg, jp, tp, x


@pytest.mark.parametrize("N,capacity", [(13, None), (13, 3), (40, 9),
                                        (1, None)])
@pytest.mark.parametrize("replay", [False, True])
def test_moe_ffn_matches_reference(N, capacity, replay):
    """Outputs within f32 TOL and equal keep masks, with and without a
    replayed drop population, at the exact-length capacity and at tight
    ones that drop."""
    jcfg, jp, tp, x = _moe_case(N, N)
    cfg = get_config(ARCH).reduced()
    jd, td = JL.moe_dims(jcfg, N), L.moe_dims(cfg, N)
    assert (jd.num_experts, jd.top_k, jd.capacity) == \
        (td.num_experts, td.top_k, td.capacity)
    if capacity is not None:
        jd = dataclasses.replace(jd, capacity=capacity)
        td = dataclasses.replace(td, capacity=capacity)
    ko = np.random.default_rng(N + 1).random((N, 2)) < 0.7 if replay \
        else None
    jy, _, jk = JL.moe_ffn(jnp.asarray(x), jp, jd, return_keep=True,
                           keep_override=None if ko is None
                           else jnp.asarray(ko))
    ty, tk = L.moe_ffn(torch.tensor(x), tp, td, return_keep=True,
                       keep_override=None if ko is None
                       else torch.tensor(ko))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    if capacity == 3:
        assert not tk.all(), "the tight capacity must drop claims"
    # the keep mask is returned only on request
    y_only = L.moe_ffn(torch.tensor(x), tp, td,
                       keep_override=None if ko is None
                       else torch.tensor(ko))
    assert torch.equal(y_only, ty)


@pytest.mark.parametrize("arch", [ARCH, "olmoe-1b-7b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_rows_change_no_bit(arch, dtype, monkeypatch):
    """``moe_ffn`` tells the grouped products each expert's kept claims;
    that changes no bit of its output, at the exact-length, dropless and a
    tight (dropping) capacity, with and without a replayed drop
    population, on reduced deepseek and olmoe. The counts it passes are
    the keep mask's per expert, and some expert runs short of C."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(3)
    p = {k: v.to(dtype) for k, v in
         L.init_moe_params(cfg, 64, gen, "cpu").items()}
    x = torch.tensor(_rand(np.random.default_rng(4), 13, 64)).to(dtype)
    ko = torch.tensor(np.random.default_rng(5).random((13, cfg.moe.top_k))
                      < 0.7)
    seen, short = [], False
    grouped = ops.grouped_mvm

    def record(x, w, rows=None, *, impl="kernel"):
        seen.append(rows)
        return grouped(x, w, rows, impl=impl)

    def no_rows(x, w, rows=None, *, impl="kernel"):
        return grouped(x, w, impl=impl)

    for dims in (L.moe_dims(cfg, 13), L.moe_dims_dropless(cfg, 13),
                 dataclasses.replace(L.moe_dims(cfg, 13), capacity=2)):
        for override in (None, ko):
            monkeypatch.setattr(ops, "grouped_mvm", record)
            y, keep = L.moe_ffn(x, p, dims, keep_override=override,
                                return_keep=True)
            monkeypatch.setattr(ops, "grouped_mvm", no_rows)
            assert torch.equal(y, L.moe_ffn(x, p, dims,
                                            keep_override=override))
            _, idx = torch.topk(torch.softmax(
                x.float() @ p["router"].float(), -1), cfg.moe.top_k)
            want = torch.zeros(cfg.moe.num_experts, dtype=torch.int32)
            want.index_add_(0, idx[keep], torch.ones_like(idx[keep],
                                                          dtype=torch.int32))
            assert len(seen) == 3 and all(torch.equal(r, want) for r in seen)
            short |= int(want.min()) < dims.capacity
            seen.clear()
    assert short


def test_moe_dims_match_reference():
    jcfg, cfg = jget(ARCH), get_config(ARCH)
    for n in (1, 5, 8, 127, 128, 300, 512, 4096):
        j, t = JL.moe_dims(jcfg, n), L.moe_dims(cfg, n)
        assert (j.num_experts, j.top_k, j.capacity) == \
            (t.num_experts, t.top_k, t.capacity)
        j, t = JL.moe_dims_dropless(jcfg, n), L.moe_dims_dropless(cfg, n)
        assert j.capacity == t.capacity


def test_moe_ffn_combine_is_bf16_in_expert_order():
    """bf16 tokens: the reference's combine rounds each token's k
    weighted expert outputs into a bf16 row in ascending expert order;
    the port's sum is bit-equal to that order, not merely close."""
    jcfg, jp, tp, x = _moe_case(5, 24)
    cfg = get_config(ARCH).reduced()
    tpb = {k: v.to(torch.bfloat16) for k, v in tp.items()}
    xb = torch.tensor(x).to(torch.bfloat16)
    dims = L.moe_dims_dropless(cfg, 24)
    got = L.moe_ffn(xb, tpb, dims)
    # the same function spelled out: per token, expert outputs in
    # ascending expert order, each weighted product and sum in bf16
    probs = torch.softmax(xb.float() @ tpb["router"].float(), dim=-1)
    gv, gi = torch.topk(probs, 2, dim=-1)
    want = torch.zeros_like(xb)
    for n in range(24):
        for k in torch.argsort(gi[n]).tolist():
            e = int(gi[n, k])
            h = ops.moe_expert_ffn(xb[n][None, None], tpb["w_gate"][e:e + 1],
                                   tpb["w_up"][e:e + 1],
                                   tpb["w_down"][e:e + 1])[0, 0]
            want[n] = want[n] + h * gv[n, k].to(torch.bfloat16)
    assert torch.equal(got, want)


# --- the model ---------------------------------------------------------------------


def test_init_params_shapes_and_dtypes_match_reference(models):
    jcfg, jp, cfg, tp = models
    mine = M.init_params(cfg, seed=0, device="cpu")

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], path + k + ".")
                continue
            assert tuple(a[k].shape) == tuple(b[k].shape), path + k
            assert a[k].dtype == b[k].dtype, path + k

    walk(mine, tp)
    assert tp["blocks"]["kv_ln"].dtype == torch.float32
    assert tp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16


def test_forward_and_static_decode_match_reference(models):
    jcfg, jp, cfg, tp = models
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12),
                                             dtype=np.int32)
    want, jkeep = JM.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                             return_route_keep=True)
    got, tkeep = M.forward(cfg, tp, {"tokens": torch.tensor(toks)},
                           return_route_keep=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_BF16)
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))

    jl, js = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 16)
    tl, ts = M.prefill(cfg, tp, {"tokens": torch.tensor(toks)}, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
    np.testing.assert_allclose(_np(ts.kv), np.asarray(js.kv, np.float32),
                               **TOL_BF16)
    tok = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        jl, js = JM.decode_step(jcfg, jp, js, jnp.asarray(tok))
        tl, ts = M.decode_step(cfg, tp, ts, torch.tensor(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL_BF16)
        assert np.array_equal(tl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    assert ts.pos == int(js.pos) == 15


def _paged_setup(cfg, jcfg, lengths, page=4, M_=6):
    """Both packages' pools holding one prefilled prompt per slot."""
    B = len(lengths)
    P = 1 + B * M_
    table = np.zeros((B, M_), np.int32)
    for b in range(B):
        table[b] = 1 + b * M_ + np.arange(M_)
    return (JM.init_paged_decode_state(jcfg, P, page),
            M.init_paged_decode_state(cfg, P, page, device="cpu"), table)


def _greedy_consistent(got, want):
    """The port's greedy token equals the reference's, or sits within
    GREEDY_GAP of the reference's max logit (a bf16 tie: the repository's
    standard, tests/_torch_parity.py); the step then continues on the
    reference's token."""
    for g, w in zip(got, want):
        assert w.max() - w[g.argmax()] <= GREEDY_GAP, (g.argmax(),
                                                       w.argmax())


def test_paged_prefill_and_decode_step_match_reference(models):
    """Padded prompts at the exact-length capacity: last-token logits,
    latents and route keeps; then per-slot decode steps over the pages,
    with a slot going idle."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(6)
    lengths = [7, 12]
    S, page = 12, 4
    toks = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    for b, n in enumerate(lengths):
        toks[b, n:] = 0
    cap = JL.moe_dims(jcfg, sum(lengths)).capacity
    (jlast, jlat, jkeep), (elast, elat, ekeep) = both_runs(
        JM.paged_prefill, jcfg, jp, {"tokens": jnp.asarray(toks)},
        jnp.asarray(lengths, jnp.int32), route_capacity=cap)
    tlast, tlat, tkeep = M.paged_prefill(
        cfg, tp, {"tokens": torch.tensor(toks)},
        torch.tensor(lengths, dtype=torch.int32), route_capacity=cap)
    close_to_reference(tlast, jlast, elast)
    close_to_reference(_np(tlat), jlat, elat)
    # keeps: exact against the op-by-op run, and against the compiled run
    # wherever the two agree (on these inputs they disagree on one claim
    # of layer 1: token 10 of row 1, whose 2nd and 3rd router
    # probabilities are 0.1797 and 0.1785 in the op-by-op run)
    ekeep, jk = np.asarray(ekeep), np.asarray(jkeep)
    np.testing.assert_array_equal(tkeep.numpy(), ekeep)
    same = ekeep == jk
    np.testing.assert_array_equal(tkeep.numpy()[same], jk[same])
    assert same.mean() > 0.95

    js, ts, table = _paged_setup(cfg, jcfg, lengths, page)
    for b in range(2):
        pids = table[b, :S // page]
        js = JM.write_prefill_pages(jcfg, js, elat[:, b], jnp.asarray(pids))
        M.write_prefill_pages(cfg, ts, tlat[:, b], torch.tensor(pids))
    tok = np.asarray(elast).argmax(-1).astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    active = np.asarray([True, True])
    for step in range(5):
        if step == 3:
            active = np.asarray([True, False])     # a slot goes idle
        (jl, _), (el, js) = both_runs(
            JM.paged_decode_step, jcfg, jp, js, jnp.asarray(tok),
            jnp.asarray(table), jnp.asarray(lens), jnp.asarray(active))
        tl = M.paged_decode_step(cfg, tp, ts, torch.tensor(tok),
                                 torch.tensor(table), torch.tensor(lens),
                                 torch.tensor(active))
        live = np.flatnonzero(active)
        close_to_reference(tl.numpy()[live], np.asarray(jl)[live],
                            np.asarray(el)[live])
        tok = np.asarray(el).argmax(-1).astype(np.int32)
        _greedy_consistent(tl.numpy()[live], np.asarray(el)[live])
        lens = lens + active
    np.testing.assert_allclose(
        _np(ts.kv_pages[:, 1:]), np.asarray(js.kv_pages, np.float32)[:, 1:],
        **TOL_BF16)


def test_paged_decode_multi_matches_reference(models):
    """The fused horizon: tokens equal, lengths/remaining advanced alike,
    a slot whose budget ends mid-horizon stops there."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(8)
    lengths = [5, 9]
    S, page, h = 12, 4, 6
    toks = rng.integers(0, cfg.vocab_size, (2, S), dtype=np.int32)
    jlast, jlat, _ = JM.paged_prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                      jnp.asarray(lengths, jnp.int32))
    js, ts, table = _paged_setup(cfg, jcfg, lengths, page)
    tlat = torch.tensor(np.asarray(jlat, np.float32)).to(torch.bfloat16)
    for b in range(2):
        pids = table[b, :S // page]
        js = JM.write_prefill_pages(jcfg, js, jlat[:, b], jnp.asarray(pids))
        M.write_prefill_pages(cfg, ts, tlat[:, b], torch.tensor(pids))
    pending = np.asarray(jlast).argmax(-1).astype(np.int32)
    remaining = np.asarray([h, 3], np.int32)
    mask = np.asarray([True, True])
    (jout, *_), (eout, _, epend, elen, erem) = both_runs(
        JM.paged_decode_multi, jcfg, jp, js, jnp.asarray(pending),
        jnp.asarray(lengths, jnp.int32), jnp.asarray(remaining),
        jnp.asarray(table), jnp.asarray(mask), jnp.asarray(h, jnp.int32),
        hmax=8)
    tpend = torch.tensor(pending)
    tlen = torch.tensor(lengths, dtype=torch.int32)
    trem = torch.tensor(remaining)
    tout = M.paged_decode_multi(cfg, tp, ts, tpend, tlen, trem,
                                torch.tensor(table), torch.tensor(mask), h,
                                hmax=8)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(eout))
    np.testing.assert_array_equal(tpend.numpy(), np.asarray(epend))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(elen))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(erem))
    # the compiled run advances the same slots by the same steps
    assert np.array_equal(np.asarray(eout) == 0, np.asarray(jout) == 0)


def test_registry_and_the_gqa_branch():
    """get_model serves dense, moe (the MLA branch and olmoe's GQA-MoE
    branch), encdec (whisper), ssm (rwkv6) and hybrid (recurrentgemma); a
    family neither package has raises clearly."""
    from repro_torch.models import griffin, rwkv6, whisper
    assert get_model(get_config(ARCH)).init_params is M.init_params
    olmoe = get_config("olmoe-1b-7b").reduced()
    assert get_model(olmoe).decode_step is M.decode_step
    p = get_model(olmoe).init_params(olmoe, device="cpu")
    assert set(p["blocks"]) == {"ln1", "ln2", "wq", "wk", "wv", "wo", "moe"}
    assert get_model(get_config("whisper-tiny")).prefill is whisper.prefill
    assert get_model(get_config("rwkv6-7b")).prefill is rwkv6.prefill
    assert get_model(get_config("recurrentgemma-9b")).prefill \
        is griffin.prefill
    unknown = dataclasses.replace(get_config("rwkv6-7b"), family="retnet")
    with pytest.raises(ValueError, match="no model in the port"):
        get_model(unknown)
