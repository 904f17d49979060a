"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips (decided inside the
fixture, so every pytest worker collects the same tests). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

bf16 in and out: kernel and plain version both round the f32 result to
bf16, so they agree within tests/test_kernels.py's bf16 TOL (2e-2); f32
in and out (the packed canvas, the grouped expert GEMM) within its f32
TOL (rtol 1e-4, atol 2e-4: summation order only). The flash backward's
gradients are also held, each as a whole, within a relative Frobenius
error of GRAD_REL (1e-2): at whisper's 448 x 1,500 cross attention a
typical dK or dV value is about TOL's atol.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_mvm as gm
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import transformer as T
from repro_torch.runtime import Engine, EngineConfig, poisson_trace

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-2, atol=2e-2)
GRAD_REL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bf16(rng, shape, dev):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=dev).to(torch.bfloat16)


@pytest.mark.parametrize("B,KV,G,dh,page,lengths", [
    (4, 2, 1, 128, 16, [0, 1, 63, 200]),
    (3, 4, 4, 128, 16, [64, 65, 1000]),
    (2, 2, 8, 64, 8, [17, 0]),
    (2, 1, 2, 64, 4, [5, 9]),
])
def test_paged_decode_kernel_matches_plain(dev, B, KV, G, dh, page, lengths):
    rng = np.random.default_rng(0)
    M = -(-max(lengths) // page) + 1
    P = 1 + B * M
    q = _bf16(rng, (B, KV * G, dh), dev)
    kp, vp = _bf16(rng, (KV, P, page, dh), dev), _bf16(rng, (KV, P, page, dh),
                                                       dev)
    table = torch.zeros((B, M), dtype=torch.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, n in enumerate(lengths):
        k = -(-n // page)
        table[b, :k] = torch.tensor(perm[b * M:b * M + k])
    args = (q, kp, vp, table.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))
    n0 = dec.paged_decode_attention.launches
    got = ops.paged_decode_attention(*args)
    assert dec.paged_decode_attention.launches == n0 + 1
    want = ops.paged_decode_attention(*args, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[b] == 0)


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("B,KV,G,dh,page,lengths", [
    (3, 2, 7, 128, 16, [0, 130, 1000]),
    (2, 3, 12, 64, 16, [64, 517]),
    (2, 2, 16, 128, 8, [33, 0]),
    (4, 1, 7, 64, 4, [1, 63, 64, 65]),
])
def test_paged_decode_kernel_any_g_and_splits(dev, splits, B, KV, G, dh, page,
                                              lengths):
    """The paged kernel at G 7, 12 and 16, dh 64 and 128, in one and in
    three splits (the combine kernel), against its plain version."""
    rng = np.random.default_rng(G * dh + splits)
    M = -(-max(lengths) // page) + 2
    P = 1 + B * M
    q = _bf16(rng, (B, KV, G, dh), dev)
    kp, vp = _bf16(rng, (KV, P, page, dh), dev), _bf16(rng, (KV, P, page, dh),
                                                       dev)
    table = torch.zeros((B, M), dtype=torch.int32)
    perm = rng.permutation(np.arange(1, P))
    for b, n in enumerate(lengths):
        k = -(-n // page)
        table[b, :k] = torch.tensor(perm[b * M:b * M + k])
    table, lens = table.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                              device=dev)
    n0 = dec.paged_decode_attention.launches
    got = dec.paged_decode_attention(q, kp, vp, table, lens, splits=splits)
    assert dec.paged_decode_attention.launches == n0 + 1
    want = ops.paged_decode_attention(q.view(B, KV * G, dh), kp, vp, table,
                                      lens, impl="ref").view(B, KV, G, dh)
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[b] == 0)


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal,window", [
    (1, 4, 4, 128, 128, 128, True, 0),
    (2, 4, 2, 130, 130, 128, True, 0),
    (1, 8, 2, 64, 130, 128, True, 0),
    (2, 4, 1, 1, 77, 64, True, 0),
    (1, 4, 2, 100, 100, 64, False, 0),
    (1, 4, 4, 200, 200, 128, True, 48),
    (1, 2, 2, 1500, 1500, 64, False, 0),   # S off the 64-row query tile
    (2, 8, 2, 100, 300, 128, True, 0),     # S < T with GQA
    (1, 4, 2, 256, 256, 64, True, 70),     # a window across tile edges
])
def test_flash_kernel_matches_plain(dev, B, H, KV, S, T, dh, causal, window):
    rng = np.random.default_rng(1)
    q = _bf16(rng, (B, S, H, dh), dev)
    k, v = _bf16(rng, (B, T, KV, dh), dev), _bf16(rng, (B, T, KV, dh), dev)
    n0 = fa.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.flash_attention.launches == n0 + 1
    want = ops.flash_attention(q, k, v, causal=causal, window=window,
                               impl="ref")
    torch.testing.assert_close(got.float(), want.float(), **TOL)


def test_engine_on_the_card_matches_the_cpu_plain_path(dev):
    """A small dense config (dh=64, a kernel instance) served on the card
    through both kernels and on the CPU through the plain versions: the
    same schedule, and tokens within a few bf16 quanta of greedy."""
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=256,
                      num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
                      head_dim=64, qkv_bias=True, rope_theta=1e6)
    params = T.init_params(cfg, seed=0, device=dev)
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in params.items()}
    ecfg = EngineConfig(num_slots=4, page_size=16, num_pages=33,
                        max_pages_per_seq=8, prefill_bucket=16)

    def trace():
        return poisson_trace(6, mean_interarrival=0.5, prompt_lens=(20, 40),
                             gen_lens=(8, 30), vocab_size=512, seed=3)

    g = Engine(cfg, params, ecfg).run(trace())
    c = Engine(cfg, cpu, ecfg).run(trace())
    assert (g.decode_steps, g.prefill_calls, g.host_syncs) == \
        (c.decode_steps, c.prefill_calls, c.host_syncs)
    for r in g.completed:
        seq = torch.tensor([list(r.prompt) + r.generated], device="cpu")
        logits = T.forward(cfg, cpu, {"tokens": seq})[0]
        rows = logits[len(r.prompt) - 1:-1]
        gap = (rows.max(-1).values
               - rows.gather(1, torch.tensor(r.generated)[:, None])[:, 0])
        assert gap.max().item() <= 0.0625, (r.rid, gap.max().item())


# --- packed canvas (fp and int8/int4, with and without the epilogue) -----------

# (kb, cb) cover with runs of 1, 3, 5 and 2 blocks: odd runs, unsorted input
CANVAS_BLOCKS = [(4, 1), (0, 0), (2, 1), (5, 2), (0, 1), (1, 2), (3, 2),
                 (0, 2), (2, 2), (5, 3), (1, 3)]


def _canvas_case(rng, B, x_dtype, dev):
    from repro_torch.kernels.packed_canvas import build_block_meta
    meta, _ = build_block_meta(np.asarray(CANVAS_BLOCKS))
    G, R, C = len(CANVAS_BLOCKS), 6 * 128, 4 * 128
    x = torch.tensor(rng.standard_normal((B, R)), dtype=torch.float32,
                     device=dev).to(x_dtype)
    w = torch.tensor(rng.standard_normal((G, 128, 128)) / 16,
                     dtype=torch.float32, device=dev)
    bias = torch.tensor(rng.standard_normal(C), dtype=torch.float32,
                        device=dev).to(x_dtype)
    res = torch.tensor(rng.standard_normal((B, C)), dtype=torch.float32,
                       device=dev).to(x_dtype)
    return meta, x, w, bias, res


def _close(got, want):
    tol = TOL if got.dtype == torch.bfloat16 else dict(rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("B,x_dtype,w_dtype", [
    (200, torch.bfloat16, torch.bfloat16),      # rows past every tile size
    (8, torch.bfloat16, torch.bfloat16),
    (64, torch.float32, torch.float32),
    (33, torch.float32, torch.bfloat16),
    (1, torch.bfloat16, torch.float32),
])
def test_packed_canvas_kernel_matches_plain(dev, B, x_dtype, w_dtype):
    from repro_torch.kernels import packed_canvas as pc
    meta, x, w, _, _ = _canvas_case(np.random.default_rng(B), B, x_dtype,
                                    dev)
    w = w.to(w_dtype)
    n0 = pc._packed_canvas_matmul.launches
    got = ops.packed_canvas_matmul(x, w, meta)
    assert pc._packed_canvas_matmul.launches == n0 + 1
    assert got.shape == (B, 512) and got.dtype == x_dtype
    _close(got, ops.packed_canvas_matmul(x, w, meta, impl="ref"))


@pytest.mark.parametrize("activation", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("B,x_dtype,with_bias,with_res", [
    (200, torch.bfloat16, True, True),
    (8, torch.float32, True, False),
    (70, torch.float32, False, True),
])
def test_packed_canvas_epilogue_kernel_matches_plain(
        dev, activation, B, x_dtype, with_bias, with_res):
    from repro_torch.kernels import packed_canvas as pc
    meta, x, w, bias, res = _canvas_case(np.random.default_rng(3), B,
                                         x_dtype, dev)
    w = w.to(x_dtype)
    kw = dict(bias=bias if with_bias else None,
              residual=res if with_res else None, activation=activation)
    n0 = pc._packed_canvas_epilogue.launches
    got = ops.packed_canvas_matmul(x, w, meta, **kw)
    assert pc._packed_canvas_epilogue.launches == n0 + 1
    _close(got, ops.packed_canvas_matmul(x, w, meta, impl="ref", **kw))


@pytest.mark.parametrize("precision", ["int8", "int4"])
@pytest.mark.parametrize("B,x_dtype", [(200, torch.bfloat16), (8,
                                        torch.bfloat16), (65, torch.float32)])
def test_dequant_kernel_matches_plain(dev, precision, B, x_dtype):
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import ref
    meta, x, w, _, _ = _canvas_case(np.random.default_rng(5), B, x_dtype,
                                    dev)
    payload, scales = ref.quantize_blocks(w, precision)
    n0 = dq._matmul_dq.launches
    got = ops.packed_canvas_matmul_dq(x, payload, scales, meta,
                                      precision=precision)
    assert dq._matmul_dq.launches == n0 + 1
    _close(got, ops.packed_canvas_matmul_dq(x, payload, scales, meta,
                                            precision=precision, impl="ref"))


@pytest.mark.parametrize("precision,activation", [
    ("int8", "silu"), ("int4", "gelu"), ("int4", "relu"), ("int8", "none")])
@pytest.mark.parametrize("B,x_dtype", [(200, torch.bfloat16),
                                       (9, torch.float32)])
def test_dequant_epilogue_kernel_matches_plain(dev, precision, activation, B,
                                               x_dtype):
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import ref
    meta, x, w, bias, res = _canvas_case(np.random.default_rng(7), B,
                                         x_dtype, dev)
    payload, scales = ref.quantize_blocks(w, precision)
    kw = dict(precision=precision, bias=bias, residual=res,
              activation=activation)
    n0 = dq._matmul_dq_epilogue.launches
    got = ops.packed_canvas_matmul_dq(x, payload, scales, meta, **kw)
    assert dq._matmul_dq_epilogue.launches == n0 + 1
    _close(got, ops.packed_canvas_matmul_dq(x, payload, scales, meta,
                                            impl="ref", **kw))


# (kb, cb) cover with 150 output blocks: more than the card's SMs, so one
# batch tile keeps whole runs (the small cover above is always split)
WIDE_BLOCKS = [(0, cb) for cb in range(150)] + [
    (kb, cb) for cb in range(0, 150, 3) for kb in (1 + cb % 5, 6)]


@pytest.mark.parametrize("layout", ["small", "wide"])
@pytest.mark.parametrize("fmt", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("B", [1, 8, 9, 16, 17, 32, 33, 64, 65, 128, 129,
                               200])
def test_tensor_core_routine_matches_plain(dev, layout, fmt, B):
    """bf16 x over bf16, int8 and int4 blocks at every batch tile (8 to
    128 rows) and off them, on split runs (small) and whole runs (wide);
    two launches give the same bits (a fixed order, no atomics)."""
    from repro_torch.kernels import packed_canvas as pc
    from repro_torch.kernels import ref
    blocks = CANVAS_BLOCKS if layout == "small" else WIDE_BLOCKS
    meta, _ = pc.build_block_meta(np.asarray(blocks))
    G, R, C = len(blocks), 128 * (int(meta[0].max()) + 1), \
        128 * (int(meta[1].max()) + 1)
    rng = np.random.default_rng(B)
    x = torch.tensor(rng.standard_normal((B, R)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16)
    w = torch.tensor(rng.standard_normal((G, 128, 128)) / 16,
                     dtype=torch.float32, device=dev)
    if fmt == "bf16":
        def run(impl="kernel"):
            return ops.packed_canvas_matmul(x, w.bfloat16(), meta, impl=impl)
    else:
        q, s = ref.quantize_blocks(w, fmt)

        def run(impl="kernel"):
            return ops.packed_canvas_matmul_dq(x, q, s, meta, precision=fmt,
                                               impl=impl)
    got = run()
    assert got.shape == (B, C) and got.dtype == torch.bfloat16
    assert torch.equal(got, run())
    _close(got, run("ref"))


def test_packing_entry_point_on_the_card(dev):
    """launch.pack on the card: every row, its check(), all four kernels."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import packed_canvas as pc
    from repro_torch.launch import pack
    counters = (pc._packed_canvas_matmul, pc._packed_canvas_epilogue,
                dq._matmul_dq, dq._matmul_dq_epilogue)
    before = [c.launches for c in counters]
    pack.check(pack.run("cuda"))
    assert all(c.launches > n for c, n in zip(counters, before))


# --- the fused horizon as CUDA graphs ---------------------------------------------


LEDGER = ("decode_steps", "slot_steps", "useful_slot_steps", "prefill_calls",
          "prefill_tokens", "preemptions", "peak_live_pages",
          "device_dispatches", "host_syncs", "page_table_upload_bytes",
          "new_tokens")


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_graphed_engine_matches_eager_engine(dev, family):
    """The engine with every fused horizon replayed from CUDA graphs and
    the same engine with the eager loop, on a small dense config (dh 64,
    a kernel instance) and reduced deepseek, with preemption: the same
    tokens, the same ledger and the same kernel launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import DecodeGraph
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=256,
                      num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=512,
                      head_dim=64, qkv_bias=True, rope_theta=1e6) \
        if family == "dense" else get_config("deepseek-v2-lite-16b").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=dev)
    ecfg = EngineConfig(num_slots=4, page_size=8, num_pages=17,
                        max_pages_per_seq=8, prefill_bucket=8, horizon=8)
    trace = poisson_trace(8, mean_interarrival=0.5, prompt_lens=(8, 16),
                          gen_lens=(20, 36), vocab_size=cfg.vocab_size,
                          seed=1)
    counters = ops.launch_counters()

    def run(graphed):
        engine = Engine(cfg, params, ecfg)
        be = engine.backend
        if graphed:
            be.graph = DecodeGraph(be.decode_step, ecfg.num_slots,
                                   ecfg.max_pages_per_seq, ecfg.horizon, dev)
        else:
            def eager(p, l, r, pt, mask, h, teacher=None):
                return be.decode_eager(p, l, r, pt,
                                       torch.as_tensor(mask, device=dev), h,
                                       teacher)
            be.decode_fused = eager
        before = [c.launches for c in counters]
        rep = engine.run([copy.deepcopy(r) for r in trace])
        torch.cuda.synchronize()
        return rep, [c.launches - b for c, b in zip(counters, before)], be

    grep, glaunch, gbe = run(True)
    erep, elaunch, _ = run(False)
    assert erep.preemptions > 0
    assert {r.rid: r.generated for r in grep.completed} == \
        {r.rid: r.generated for r in erep.completed}
    for f in LEDGER:
        assert getattr(grep, f) == getattr(erep, f), f
    assert glaunch == elaunch and max(glaunch) > 0
    assert gbe.graph.horizons == grep.host_syncs and gbe.graph.replays > 0


# --- grouped expert GEMM --------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,D,F", [
    (64, 8, 2048, 1408),        # deepseek-v2-lite decode, gate/up
    (64, 5, 1408, 2048),        # ragged C, down
    (4, 130, 64, 32),           # C past one 64-row tile, D < one chunk
    (3, 1, 200, 72),            # D and F off the 128 grid
    (64, 128, 2048, 1408),      # deepseek-v2-lite prefill (tensor cores)
    (8, 60, 256, 136),          # 64-row tile, a partial f-tile of 8
])
def test_grouped_mvm_kernel_matches_plain(dev, dtype, E, C, D, F):
    rng = np.random.default_rng(E * C + D)
    x = torch.tensor(rng.standard_normal((E, C, D)), dtype=torch.float32,
                     device=dev).to(dtype)
    w = torch.tensor(rng.standard_normal((E, D, F)) / D ** 0.5,
                     dtype=torch.float32, device=dev).to(dtype)
    n0 = gm.grouped_mvm.launches
    got = ops.grouped_mvm(x, w)
    assert gm.grouped_mvm.launches == n0 + 1
    assert got.shape == (E, C, F) and got.dtype == dtype
    _close(got, ops.grouped_mvm(x, w, impl="ref"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E,C,D,F", [
    (64, 5, 2048, 1408),
    (64, 8, 1408, 2048),
    (16, 16, 256, 136),         # the 16-row FMA tile
    (16, 32, 256, 128),         # the 32-row FMA tile
    (64, 64, 2048, 1408),
    (64, 128, 2048, 1408),
    (8, 200, 256, 136),         # two c-tiles, the second partly live
])
def test_grouped_mvm_kernel_with_rows_matches_plain(dev, dtype, E, C, D, F):
    """Live rows per expert, some empty, some full, the rest ragged: the
    kernel writes zeros past each count (x is not zero there, so a row
    that read x would show) and matches the plain version."""
    rng = np.random.default_rng(E + C + D)
    x = torch.tensor(rng.standard_normal((E, C, D)), dtype=torch.float32,
                     device=dev).to(dtype)
    w = torch.tensor(rng.standard_normal((E, D, F)) / D ** 0.5,
                     dtype=torch.float32, device=dev).to(dtype)
    rows = rng.integers(0, C + 1, E)
    rows[:3] = (0, C, 1)
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    n0 = gm.grouped_mvm.launches
    got = ops.grouped_mvm(x, w, rows)
    assert gm.grouped_mvm.launches == n0 + 1
    dead = torch.arange(C, device=dev)[None, :] >= rows[:, None]
    assert torch.all(got[dead] == 0)
    _close(got, ops.grouped_mvm(x, w, rows, impl="ref"))


def test_grouped_mvm_kernel_refuses_what_it_cannot_take(dev):
    x = torch.zeros((2, 3, 12), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiples"):
        ops.grouped_mvm(x, torch.zeros((2, 12, 16), dtype=torch.bfloat16,
                                       device=dev))
    with pytest.raises(ValueError, match="share"):
        ops.grouped_mvm(x[..., :8].contiguous(),
                        torch.zeros((2, 8, 16), device=dev))


def test_latent_engine_on_the_card_matches_the_cpu_plain_path(dev):
    """The reduced deepseek config served on the card (grouped-GEMM
    kernel for every expert product) and on the CPU (plain versions):
    the same schedule, and every token within a few bf16 quanta of the
    static path's greedy choice, teacher-forced on the CPU."""
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b").reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=dev)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cpu = to_cpu(params)
    ecfg = EngineConfig(num_slots=4, page_size=8, num_pages=33,
                        max_pages_per_seq=8, prefill_bucket=8)

    def trace():
        return poisson_trace(6, mean_interarrival=0.5, prompt_lens=(6, 12),
                             gen_lens=(8, 20), vocab_size=cfg.vocab_size,
                             seed=3)

    n0 = gm.grouped_mvm.launches
    g = Engine(cfg, params, ecfg).run(trace())
    assert gm.grouped_mvm.launches > n0
    c = Engine(cfg, cpu, ecfg).run(trace())
    assert (g.decode_steps, g.prefill_calls, g.host_syncs) == \
        (c.decode_steps, c.prefill_calls, c.host_syncs)
    for r in g.completed:
        logits, state = api.prefill(
            cfg, cpu, {"tokens": torch.tensor([list(r.prompt)])},
            len(r.prompt) + len(r.generated))
        rows = [logits[0]]
        for t in r.generated[:-1]:
            logits, state = api.decode_step(cfg, cpu, state,
                                            torch.tensor([t]))
            rows.append(logits[0])
        rows = torch.stack(rows)
        gap = (rows.max(-1).values
               - rows.gather(1, torch.tensor(r.generated)[:, None])[:, 0])
        assert gap.max().item() <= 0.0625, (r.rid, gap.max().item())


# --- dense decode attention (static decode's one query over its cache) ---------


@pytest.mark.parametrize("B,T,KV,G,dh,lengths", [
    (8, 640, 16, 1, 128, [640, 1, 0, 639, 64, 65, 300, 17]),
    (2, 1500, 6, 1, 64, [1500, 1500]),
    (3, 77, 2, 4, 64, [0, 77, 40]),
    (2, 130, 2, 8, 128, [130, 129]),
    (2, 96, 4, 2, 128, [200, 50]),        # lengths past T: masked by T
    (2, 100, 2, 3, 128, [100, 65]),
    (3, 200, 1, 7, 128, [1, 65, 200]),
    (2, 640, 2, 12, 64, [640, 0]),
    (2, 130, 1, 16, 128, [130, 1]),
    (3, 1500, 2, 7, 64, [0, 1500, 65]),
    (2, 300, 1, 20, 128, [300, 1]),       # G > 16: two query groups
])
def test_decode_kernel_matches_plain_on_strided_views(dev, B, T, KV, G, dh,
                                                      lengths):
    """The static cache layer (B, T, KV, dh) reaches the kernel as its
    transposed view, with no copy; a cache sliced to fewer positions
    keeps its strides, and the kernel reads no key past the true T."""
    rng = np.random.default_rng(2)
    q = _bf16(rng, (B, KV * G, dh), dev)
    cache = _bf16(rng, (2, B, T + 5, KV, dh), dev)
    k, v = cache[0, :, :T], cache[1, :, :T]          # strided views
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    n0 = dec.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens)
    assert dec.decode_attention.launches == n0 + 1
    torch.cuda.synchronize()
    want = ops.decode_attention(q, k, v, lens, impl="ref")
    torch.testing.assert_close(got.float(), want.float(), **TOL)
    for b, n in enumerate(lengths):
        if n == 0:
            assert torch.all(got[b] == 0)


def test_decode_kernel_refuses_what_it_cannot_take(dev):
    rng = np.random.default_rng(3)
    q = _bf16(rng, (2, 4, 64), dev)
    k = _bf16(rng, (2, 10, 2, 64), dev)
    lens = torch.tensor([10, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.decode_attention(q, k.float(), k, lens)
    with pytest.raises(ValueError, match="int32"):
        ops.decode_attention(q, k, k, lens.long())
    odd = _bf16(rng, (2, 10, 2, 65), dev)[..., :64]  # rows not 16-byte aligned
    with pytest.raises(ValueError, match="aligned"):
        ops.decode_attention(q, odd, odd, lens)
    q32, k32 = _bf16(rng, (2, 4, 32), dev), _bf16(rng, (2, 10, 2, 32), dev)
    with pytest.raises(ValueError, match="dh=32"):
        ops.decode_attention(q32, k32, k32, lens)
    q7 = _bf16(rng, (2, 14, 64), dev)          # G = 7: any G has a kernel
    torch.testing.assert_close(
        ops.decode_attention(q7, k, k, lens).float(),
        ops.decode_attention(q7, k, k, lens, impl="ref").float(), **TOL)


@pytest.mark.parametrize("splits", [1, 2, 3, 10])
def test_decode_kernel_split_counts_agree(dev, splits):
    """Every split count gives the plain result: one split writes bf16
    directly, more go through the f32 partials and the combine kernel;
    splits past a row's length (and every split of a length-0 row) are
    empty. One launch counted per call either way."""
    rng = np.random.default_rng(4)
    B, T, KV, G, dh = 4, 600, 2, 4, 128
    q = _bf16(rng, (B, KV * G, dh), dev)
    k, v = _bf16(rng, (B, T, KV, dh), dev), _bf16(rng, (B, T, KV, dh), dev)
    lens = torch.tensor([600, 0, 70, 1], dtype=torch.int32, device=dev)
    n0 = dec.decode_attention.launches
    got = dec.decode_attention(q.view(B, KV, G, dh), k.transpose(1, 2),
                               v.transpose(1, 2), lens, splits=splits)
    assert dec.decode_attention.launches == n0 + 1
    want = ops.decode_attention(q, k, v, lens, impl="ref")
    torch.testing.assert_close(got.view(B, KV * G, dh).float(), want.float(),
                               **TOL)
    assert torch.all(got[1] == 0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-tiny"])
def test_static_family_on_the_card_matches_the_cpu_plain_path(dev, arch):
    """A reduced config widened to a kernel head size (dh 64) served by
    run_static on the card (decode kernel, flash and, for olmoe, the
    grouped GEMM) and on the CPU (plain versions): the same ledger, one
    decode launch a layer a step (two for whisper: self and cross), and
    the card's logits within a few bf16 quanta of the CPU's, teacher-
    forced with the CPU's tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.runtime import encdec_extras_fn, run_static
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64)
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=dev)

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cpu = to_cpu(params)
    extras = encdec_extras_fn(cfg) if cfg.family == "encdec" else None

    def trace():
        return poisson_trace(5, mean_interarrival=0.5, prompt_lens=(6, 12),
                             gen_lens=(4, 9), vocab_size=cfg.vocab_size,
                             seed=3, extras_fn=extras)

    n0, f0 = dec.decode_attention.launches, fa.flash_attention.launches
    g = run_static(cfg, params, trace(), num_slots=2)
    per_step = cfg.num_layers * (2 if cfg.family == "encdec" else 1)
    assert dec.decode_attention.launches - n0 == per_step * g.decode_steps
    assert fa.flash_attention.launches > f0          # prefill only
    c = run_static(cfg, cpu, trace(), num_slots=2)
    for f in ("decode_steps", "slot_steps", "prefill_tokens",
              "cache_bytes_alloc"):
        assert getattr(g, f) == getattr(c, f), f

    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    batch = {"tokens": torch.tensor(toks)}
    if extras is not None:
        batch["frames"] = torch.tensor(np.stack(
            [extras(rng)["frames"] for _ in range(2)]))
    lc, sc = api.prefill(cfg, cpu, batch, 16)
    lg, sg = api.prefill(cfg, params, {k: t.to(dev) for k, t in batch.items()},
                         16)
    for _ in range(5):
        torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=0.0625)
        tok = lc.argmax(-1).to(torch.int32)
        lc, sc = api.decode_step(cfg, cpu, sc, tok)
        lg, sg = api.decode_step(cfg, params, sg, tok.to(dev))


# --- the vlm and ssm engine families -------------------------------------------


def test_vlm_engine_on_the_card_launches_the_kernels(dev):
    """A small vlm config at a kernel head size (dh 64, G 7, M-RoPE)
    served by the engine on the card, requests carrying patches, fused
    horizons graphed: one paged-decode launch a layer a decode step, one
    flash launch a layer a prefill, no shared page; the same schedule as
    the CPU's plain path, and every token within a few bf16 quanta of
    the greedy choice of the CPU forward with the request's patches."""
    from repro_torch.runtime import vlm_extras_fn
    cfg = ModelConfig(name="tiny-vl", family="vlm", num_layers=2,
                      d_model=256, num_heads=14, num_kv_heads=2, d_ff=512,
                      vocab_size=512, head_dim=64, qkv_bias=True, mrope=True,
                      rope_theta=1e6)
    params = T.init_params(cfg, seed=0, device=dev)
    cpu = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict)
               else v.cpu()) for k, v in params.items()}
    ecfg = EngineConfig(num_slots=4, page_size=16, num_pages=33,
                        max_pages_per_seq=8, prefill_bucket=16,
                        prefix_sharing=True)

    def trace():
        return poisson_trace(6, mean_interarrival=0.5, prompt_lens=(20, 40),
                             gen_lens=(8, 30), vocab_size=512, seed=3,
                             extras_fn=vlm_extras_fn(cfg))

    n0, f0 = dec.paged_decode_attention.launches, fa.flash_attention.launches
    engine = Engine(cfg, params, ecfg)
    g = engine.run(trace())
    assert dec.paged_decode_attention.launches - n0 == \
        cfg.num_layers * g.decode_steps
    assert fa.flash_attention.launches - f0 == \
        cfg.num_layers * g.prefill_calls
    assert engine.backend.graph.replays > 0 and g.shared_page_hits == 0
    c = Engine(cfg, cpu, ecfg).run(trace())
    assert (g.decode_steps, g.prefill_calls, g.host_syncs) == \
        (c.decode_steps, c.prefill_calls, c.host_syncs)
    for r in g.completed:
        seq = torch.tensor([list(r.prompt) + r.generated], device="cpu")
        pe = torch.tensor(r.extras["patch_embeds"])[None]
        logits = T.forward(cfg, cpu, {"tokens": seq, "patch_embeds": pe})[0]
        rows = logits[len(r.prompt) - 1:-1]
        gap = (rows.max(-1).values
               - rows.gather(1, torch.tensor(r.generated)[:, None])[:, 0])
        assert gap.max().item() <= 0.0625, (r.rid, gap.max().item())


def test_graphed_recurrent_engine_matches_eager_engine(dev):
    """Reduced rwkv6 through the recurrent backend, every fused horizon
    replayed from the one-step CUDA graph over the dummy (B, 1) table,
    against the same engine on the eager loop: the same tokens and
    ledger, one dispatch and one sync a horizon; each request equals its
    solo run."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import Request
    cfg = get_config("rwkv6-7b").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=dev)
    ecfg = EngineConfig(num_slots=4, page_size=8, num_pages=17,
                        max_pages_per_seq=8, prefill_bucket=8, horizon=8)
    trace = poisson_trace(8, mean_interarrival=0.5, prompt_lens=(8, 16),
                          gen_lens=(20, 36), vocab_size=cfg.vocab_size,
                          seed=1)

    def run(graphed, reqs):
        engine = Engine(cfg, params, ecfg)
        be = engine.backend
        if not graphed:
            def eager(p, l, r, pt, mask, h, teacher=None):
                return be.decode_eager(p, l, r, pt,
                                       torch.as_tensor(mask, device=dev), h,
                                       teacher)
            be.decode_fused = eager
        rep = engine.run([copy.deepcopy(r) for r in reqs])
        torch.cuda.synchronize()
        return rep, be

    grep, gbe = run(True, trace)
    erep, ebe = run(False, trace)
    assert ebe.graph is None and gbe.graph.graphed
    assert tuple(gbe.graph.table.shape) == (ecfg.num_slots, 1)
    assert {r.rid: r.generated for r in grep.completed} == \
        {r.rid: r.generated for r in erep.completed}
    for f in LEDGER + ("slot_state_bytes", "kv_bytes_peak"):
        assert getattr(grep, f) == getattr(erep, f), f
    assert gbe.graph.horizons == grep.host_syncs and gbe.graph.replays > 0
    assert grep.kv_bytes_peak == grep.slot_state_bytes > 0
    for r in grep.completed[:3]:
        solo, _ = run(True, [Request(rid=r.rid, prompt=r.prompt.copy(),
                                     max_new_tokens=r.max_new_tokens)])
        assert solo.completed[0].generated == r.generated, r.rid


def test_graphed_hybrid_engine_wraps_its_ring_as_eager(dev):
    """Reduced recurrentgemma through the hybrid backend (window 8, page
    4: a ring of 3 rows), generations far past the window so every slot's
    ring wraps, every fused horizon replayed from the one-step CUDA graph
    over the ring table, against the same engine on the eager loop: the
    same tokens and ledger, at most 3 pages a slot, no kernel of the
    eight launched; each request equals its solo run."""
    from repro_torch.configs import get_config
    from repro_torch.runtime import Request
    cfg = get_config("recurrentgemma-9b").reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device=dev)
    ecfg = EngineConfig(num_slots=4, page_size=4, num_pages=13,
                        max_pages_per_seq=3, prefill_bucket=8, horizon=8)
    trace = poisson_trace(8, mean_interarrival=0.5, prompt_lens=(6, 20),
                          gen_lens=(20, 36), vocab_size=cfg.vocab_size,
                          seed=1)
    counters = ops.launch_counters()

    def run(graphed, reqs):
        engine = Engine(cfg, params, ecfg)
        be = engine.backend
        if not graphed:
            def eager(p, l, r, pt, mask, h, teacher=None):
                return be.decode_eager(p, l, r, pt,
                                       torch.as_tensor(mask, device=dev), h,
                                       teacher)
            be.decode_fused = eager
        before = [c.launches for c in counters]
        rep = engine.run([copy.deepcopy(r) for r in reqs])
        torch.cuda.synchronize()
        assert [c.launches for c in counters] == before
        return rep, be

    grep, gbe = run(True, trace)
    erep, ebe = run(False, trace)
    assert ebe.graph is None and gbe.graph.graphed
    assert gbe.ring_rows == 3 and grep.peak_live_pages <= 4 * 3
    assert {r.rid: r.generated for r in grep.completed} == \
        {r.rid: r.generated for r in erep.completed}
    for f in LEDGER + ("slot_state_bytes", "kv_bytes_peak", "page_bytes"):
        assert getattr(grep, f) == getattr(erep, f), f
    assert all(not r.truncated and len(r.generated) == r.max_new_tokens
               for r in grep.completed)
    assert gbe.graph.horizons == grep.host_syncs and gbe.graph.replays > 0
    for r in grep.completed[:3]:
        solo, _ = run(True, [Request(rid=r.rid, prompt=r.prompt.copy(),
                                     max_new_tokens=r.max_new_tokens)])
        assert solo.completed[0].generated == r.generated, r.rid


# --- the multi-tenant pool ------------------------------------------------------


def test_device_dma_channel_overlaps_a_decode_on_its_stream(dev):
    """The device channel copies each ticked byte from pinned host memory
    on its own stream: a copy issued before a long decode-sized burst of
    compute on the default stream is done when the compute is (no
    measured stall at the next tick), while a tick right behind a large
    copy waits for it (one measured stall); the modeled ledger is the
    plain channel's throughout."""
    from repro_torch.runtime import DeviceDmaChannel, DmaChannel
    n = 256 << 20
    ch, plain = DeviceDmaChannel(n, device=dev), DmaChannel(n)
    for c in (ch, plain):
        c.enqueue("a", 5 * n)
    x = torch.randn((4096, 4096), device=dev, dtype=torch.bfloat16)
    assert ch.tick() == plain.tick() == n
    for _ in range(200):            # tens of ms of compute on the default
        x = torch.tanh(x @ x)       # stream while the copy runs
    torch.cuda.current_stream().synchronize()
    assert ch.tick() == plain.tick() == n
    assert ch.measured_stall_steps == 0
    assert ch.tick() == plain.tick() == n   # back to back: it waits
    assert ch.measured_stall_steps == 1 and ch.measured_wait_s > 0
    ch.check()
    assert ch.copies_issued == 3 and ch.copied_bytes == 3 * n
    assert ch.queue == plain.queue and ch.remaining("a") == 2 * n
    assert bool((ch._slabs[1][:1024] == 1).all())
    ch.reset()
    ch.check()


def _tiny_pool_zoo(dev):
    """A small dense config (dh 64, a kernel instance) and reduced rwkv6
    and deepseek, with random weights on the card."""
    from repro_torch.configs import get_config
    cfgs = {"dense": ModelConfig(
        name="tiny", family="dense", num_layers=2, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=512, vocab_size=256, head_dim=64, qkv_bias=True,
        rope_theta=1e6)}
    for arch in ("rwkv6-7b", "deepseek-v2-lite-16b"):
        cfgs[arch] = get_config(arch).reduced()
    params = {m: get_model(c).init_params(c, seed=0, device=dev)
              for m, c in cfgs.items()}
    return cfgs, params


def test_graphed_pool_matches_eager_pool_and_measures_its_dma(dev):
    """Three tenants through one PooledEngine, layer streaming through the
    device DMA channel: every tenant's fused horizons replayed from its
    own CUDA graph against the same pool on the eager loop; the same
    tokens, ledger and launch counts, an engine step with two tenants'
    horizons, and measured DMA stalls within the modeled ones."""
    from repro_torch.runtime import (DeviceDmaChannel, ModelPool, PoolConfig,
                                     PoolEngineConfig, PooledEngine,
                                     multi_tenant_trace)
    cfgs, params = _tiny_pool_zoo(dev)
    tenants = [dict(model_id=m, vocab_size=256, share=2.0 if m == "dense"
                    else 1.0) for m in cfgs]
    trace = multi_tenant_trace(tenants, 16, mean_interarrival=0.4,
                               prompt_lens=(8, 16), gen_lens=(6, 12, 24),
                               seed=3)
    counters = ops.launch_counters()
    KiB = 1 << 10

    def run(graphed):
        # every tenant streamed, 33 modeled stall steps, and engine
        # steps that run two tenants' fused horizons
        pool = ModelPool(PoolConfig(hbm_budget_bytes=3500 * KiB,
                                    slab_frac=0.55,
                                    reload_bytes_per_step=32 * KiB,
                                    hysteresis_steps=8, device_dma=True,
                                    dma_device="cuda"))
        for m, t in zip(cfgs, tenants):
            pool.register(m, cfgs[m], demand=t["share"])
        eng = PooledEngine(pool, params, PoolEngineConfig(
            num_slots=4, page_size=8, num_pages=49, max_pages_per_seq=8,
            prefill_bucket=8, horizon=8, stream="layer"))
        steps = []
        for m, be in eng.backends.items():
            fused = be.decode_fused if graphed else (
                lambda p, l, r, pt, mask, h, teacher=None, be=be:
                be.decode_eager(p, l, r, pt,
                                torch.as_tensor(mask, device=dev), h,
                                teacher))

            def call(*a, fused=fused, m=m):
                steps.append((eng.step, m, a[5]))
                return fused(*a)
            be.decode_fused = call
        before = [c.launches for c in counters]
        rep = eng.run([copy.deepcopy(r) for r in trace])
        torch.cuda.synchronize()
        return rep, eng, pool, steps, \
            [c.launches - b for c, b in zip(counters, before)]

    grep, geng, gpool, gsteps, glaunch = run(True)
    erep, _, _, esteps, elaunch = run(False)
    assert {r.rid: r.generated for r in grep.completed} == \
        {r.rid: r.generated for r in erep.completed}
    for f in LEDGER + ("stall_steps", "reload_bytes", "evictions",
                       "model_tokens"):
        assert getattr(grep, f) == getattr(erep, f), f
    assert gsteps == esteps and glaunch == elaunch and max(glaunch) > 0
    assert not any(r.truncated for r in grep.completed)
    assert all(n > 0 for n in grep.model_tokens.values())
    assert grep.stall_steps > 0
    at = [s for s, _, _ in gsteps]
    assert any(at.count(s) >= 2 for s in set(at))
    assert all(b.graph is not None and b.graph.graphed
               for b in geng.backends.values())
    assert sum(b.graph.replays for b in geng.backends.values()) > 0
    dma = gpool.dma
    assert isinstance(dma, DeviceDmaChannel) and dma.copies_issued > 0
    dma.check()
    assert dma.measured_stall_steps <= grep.stall_steps


# --- training: the flash backward, kernels without one, a train step ---------------

# (B, H, KV, S, T, dh, causal, packed): small and ragged shapes, then the
# three of chip_smoke (l): olmo-1b's training step, qwen2-vl-7b's G 7,
# whisper-tiny's cross attention (448 decoder rows against 1,500 frames, not
# causal); packed: q, k and v are slices of one (B, S, H + 2 KV, dh) tensor,
# so the kernels' tensor maps take strides that are not dense and an offset
# base
BWD_CASES = [
    (1, 4, 4, 128, 128, 128, True, False),
    (2, 8, 2, 130, 130, 128, True, False),     # ragged tiles, G 4
    (2, 7, 1, 100, 100, 64, True, False),      # G 7
    (1, 4, 2, 70, 200, 128, True, False),      # S < T
    (1, 2, 2, 150, 150, 64, False, False),
    (1, 2, 1, 40, 20, 64, True, False),        # S > T: rows with no key
    (8, 16, 16, 512, 512, 128, True, False),
    (8, 28, 4, 512, 512, 128, True, False),
    (8, 6, 6, 448, 1500, 64, False, False),
    (2, 8, 2, 130, 130, 128, True, True),      # packed q, k, v
    (1, 4, 4, 1, 1, 128, True, False),         # one row, one key
    (2, 4, 2, 1, 1500, 64, False, False),      # one row against 1,500 keys
    (2, 6, 3, 77, 333, 64, True, False),       # dh 64, ragged, S < T
]
# the ids the cases had before the packed flag: a packed case says so
BWD_IDS = ["-".join(map(str, c[:7])) + ("-packed" if c[7] else "")
           for c in BWD_CASES]


def _close_grad(got, want):
    """Within TOL element by element, and within GRAD_REL as a whole where
    the reference is not zero (a row that sees one key has dS = 0, so dQ
    and dK are zero but for rounding, and no relative error exists)."""
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, **TOL)
    norm = torch.linalg.vector_norm(want).item()
    if norm:
        rel = torch.linalg.vector_norm(got - want).item() / norm
        assert rel <= GRAD_REL, f"relative Frobenius error {rel:.3e}"


def _bwd_inputs(dev, B, H, KV, S, T, dh, seed=2, packed=False):
    rng = np.random.default_rng(seed)
    if packed:                      # S == T: one projection's output
        qkv = _bf16(rng, (B, S, H + 2 * KV, dh), dev)
        return (qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:],
                _bf16(rng, (B, S, H, dh), dev))
    return (_bf16(rng, (B, S, H, dh), dev), _bf16(rng, (B, T, KV, dh), dev),
            _bf16(rng, (B, T, KV, dh), dev), _bf16(rng, (B, S, H, dh), dev))


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal,packed", BWD_CASES,
                         ids=BWD_IDS)
def test_flash_forward_lse_matches_plain(dev, B, H, KV, S, T, dh, causal,
                                         packed):
    """The forward's second output, each row's log-sum-exp (+inf with no
    visible key), within f32 rounding; the attention output unchanged."""
    from repro_torch.kernels import ref
    q, k, v, _ = _bwd_inputs(dev, B, H, KV, S, T, dh, packed=packed)
    out, lse = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), return_lse=True,
                                  causal=causal)
    want = ref.attention_lse(q, k, causal=causal)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    live = ~torch.isinf(want)
    torch.testing.assert_close(lse[live], want[live], rtol=1e-5, atol=1e-4)
    assert torch.equal(out.transpose(1, 2),
                       ops.flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal,packed", BWD_CASES,
                         ids=BWD_IDS)
def test_flash_backward_kernels_match_plain(dev, B, H, KV, S, T, dh, causal,
                                            packed):
    """Each backward launch against its plain version on the same inputs,
    and the whole against autograd through ``ref.mha_attention`` in f32
    from the same bf16 inputs (``ref.flash_attention_bwd`` where rows see
    no key, which ``mha_attention`` averages), within the bf16 TOL and
    GRAD_REL; one launch of each a backward; bit-for-bit repeatable (no
    atomics)."""
    from repro_torch.kernels import ref
    q, k, v, do = _bwd_inputs(dev, B, H, KV, S, T, dh, packed=packed)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = fa.flash_attention(qt, kt, vt, return_lse=True, causal=causal)
    kernels = (fa.flash_bwd_rowdot, fa.flash_bwd_dkdv, fa.flash_bwd_dq)
    n0 = [c.launches for c in kernels]
    delta = fa.flash_bwd_rowdot(out, dot)
    dk, dv = fa.flash_bwd_dkdv(qt, kt, vt, dot, lse, delta, causal=causal)
    dq = fa.flash_bwd_dq(qt, kt, vt, dot, lse, delta, causal=causal)
    assert [c.launches - n for c, n in zip(kernels, n0)] == [1, 1, 1]
    torch.testing.assert_close(
        delta, ref.flash_bwd_rowdot(out.transpose(1, 2), do), rtol=1e-4,
        atol=1e-3)
    wk, wv = ref.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal)
    wq = ref.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
    for got, want in zip((dq, dk, dv), (wq, wk, wv)):
        _close_grad(got.transpose(1, 2), want)
    if causal and S > T:
        exact = ref.flash_attention_bwd(q, k, v, do, causal=causal)
    else:
        ts = [t.float().requires_grad_() for t in (q, k, v)]
        ref.mha_attention(*ts, causal=causal).backward(do.float())
        exact = [t.grad for t in ts]
    for got, want in zip((dq, dk, dv), exact):
        _close_grad(got.transpose(1, 2), want)
    again = fa.flash_attention_bwd(qt, kt, vt, out, dot, lse, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))


def test_flash_autograd_on_the_card(dev):
    """``ops.flash_attention`` under autograd: the kernel forward (with
    its log-sum-exp) and the three backward launches, the gradients of
    autograd through the plain version within TOL and GRAD_REL; a window
    under grad
    raises."""
    from repro_torch.kernels import ref
    q, k, v, do = _bwd_inputs(dev, 2, 8, 2, 200, 200, 128)
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    n0 = (fa.flash_attention.launches, fa.flash_bwd_dq.launches)
    ops.flash_attention(*ts, causal=True).backward(do)
    assert (fa.flash_attention.launches - n0[0],
            fa.flash_bwd_dq.launches - n0[1]) == (1, 1)
    plain = [t.float().requires_grad_() for t in (q, k, v)]
    ref.mha_attention(*plain).backward(do.float())
    for t, want in zip(ts, plain):
        _close_grad(t.grad, want.grad)
    with pytest.raises(ValueError, match="no window"):
        ops.flash_attention(*ts, window=64)


def test_kernels_without_a_backward_raise_under_grad(dev):
    """No gradient is dropped without an error: every kernel wrapper
    without a backward raises when an input requires grad and grad mode
    is on (the flash forward's and the grouped GEMM's own wrappers too:
    their backwards run through ``ops.flash_attention`` and
    ``ops.grouped_mvm``, and the grouped backward's wrappers have none of
    their own), and runs under ``torch.no_grad``."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    q = _bf16(rng, (2, 4, 64), dev)
    cache = _bf16(rng, (2, 32, 2, 64), dev)
    lengths = torch.tensor([5, 32], dtype=torch.int32, device=dev)
    pages = _bf16(rng, (2, 5, 8, 64), dev)
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    x, w = _bf16(rng, (2, 8, 64), dev), _bf16(rng, (2, 64, 32), dev)
    w_down = _bf16(rng, (2, 32, 64), dev)
    # two occupied 128 x 128 blocks, (kb, cb) = (0, 1) and (1, 0)
    meta, _ = ops.build_block_meta(np.array([[0, 1], [1, 0]]))
    wb, xp = _bf16(rng, (2, 128, 128), dev), _bf16(rng, (4, 256), dev)
    dy = _bf16(rng, (2, 8, 32), dev)
    payload, scales = ref.quantize_blocks(wb, "int8")
    kv = cache.transpose(1, 2)
    # (name, call, the input made to require grad)
    cases = [
        ("decode_attention", lambda t: ops.decode_attention(
            t, cache, cache, lengths), q),
        ("paged_decode_attention", lambda t: ops.paged_decode_attention(
            t, pages, pages, table, lengths), q),
        ("grouped_mvm wrapper", lambda t: gm.grouped_mvm(t, w), x),
        ("grouped_mvm_bwd_dx", lambda t: gm.grouped_mvm_bwd_dx(t, w_down),
         x),
        ("grouped_mvm_bwd_dw", lambda t: gm.grouped_mvm_bwd_dw(x, t), dy),
        ("packed canvas", lambda t: ops.packed_canvas_matmul(xp, t, meta),
         wb),
        ("packed canvas epilogue", lambda t: ops.packed_canvas_matmul(
            t, wb, meta, activation="gelu"), xp),
        ("dequant", lambda t: ops.packed_canvas_matmul_dq(
            t, payload, scales, meta, precision="int8"), xp),
        ("flash_attention wrapper", lambda t: fa.flash_attention(t, kv, kv),
         kv),
    ]
    for name, call, t in cases:
        with torch.no_grad():
            call(t.clone().requires_grad_())
        with pytest.raises(RuntimeError, match="requires grad"):
            call(t.clone().requires_grad_())


def test_olmo_train_step_kernels_match_the_plain_route(dev, monkeypatch):
    """olmo-1b at full width cut to 2 layers, B 2 x 256 tokens, from the
    same f32 masters on the card: the loss and every leaf's gradient
    through the flash kernels (forward and backward) against the plain
    route (autograd through ``ref.mha_attention``), the loss within the
    bf16 TOL and each leaf within a relative Frobenius error of 2e-2; then
    one ``make_train_step`` step each way, the losses equal within TOL."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import compute_view, master_params
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves
    cfg = dataclasses.replace(get_config("olmo-1b"), num_layers=2)
    batch = {k: v.to(dev) for k, v in TokenStream(
        cfg.vocab_size, 256, 2, seed=0).batch(0).items()}
    init = master_params(T.init_params(cfg, seed=0, device=dev))
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(ops, "_plain", lambda impl, x: True)
        n0 = fa.flash_bwd_dq.launches
        params = {k: ({n: t.clone() for n, t in v.items()}
                      if isinstance(v, dict) else v.clone())
                  for k, v in init.items()}
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss = T.loss_fn(cfg, compute_view(params), batch)
        # olmo's non-parametric norms are empty leaves, outside the graph
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        step = make_train_step(cfg, lr=1e-3, warmup=2, total=10)
        _, _, m = step(params, adamw_init(params), batch)
        runs[route] = (float(loss.detach()),
                       [g for g in grads if g is not None],
                       float(m["loss"]), fa.flash_bwd_dq.launches - n0)
    (lk, gk, mk, nk), (lp, gp, mp, np_) = runs["kernel"], runs["plain"]
    assert (nk, np_) == (2 * cfg.num_layers, 0)
    np.testing.assert_allclose(lk, lp, rtol=2e-2)
    np.testing.assert_allclose(mk, mp, rtol=2e-2)
    assert len(gk) == len(gp) > 0
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 2e-2


def test_train_entry_point_refuses_without_cuda(dev, monkeypatch):
    """With the card hidden, ``launch.train`` raises rather than training
    on the CPU unasked."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])


# --- MoE training: the grouped GEMM's backward, an olmoe train step ---------------

# (E, C, D, F, full): ragged rows (one expert with none, one full) past one
# 128-row tile, D and F off the 128 grid, C under one tile, and olmoe-1b-7b's
# training shape (C 640 at B 8 x 512); then the edges of the TMA tiles: one
# expert, C 1, C exactly 64, D = F = 8 (the wrapper's least), a C off the
# 64-row chunk with every expert full (``full``), and three row tiles
# under three column tiles (dX's walk pairs an odd last live row tile
# across column tiles, the third alone)
GROUPED_BWD_CASES = [
    (4, 130, 64, 32, False),
    (3, 60, 200, 72, False),
    (8, 256, 256, 136, False),
    (64, 640, 2048, 1024, False),
    (1, 200, 128, 64, False),
    (4, 1, 64, 72, False),
    (4, 64, 128, 96, False),
    (4, 100, 8, 8, False),
    (4, 200, 136, 72, True),
    (6, 300, 520, 64, False),
]


def _grouped_bwd_inputs(dev, E, C, D, F, seed=3, full=False):
    """x, w, dy and the live rows: drawn from [0, C], the first expert
    with none and the second full where E > 1; all C with ``full``."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, C + 1, E)
    if full:
        rows[:] = C
    elif E > 1:
        rows[:2] = (0, C)
    return (_bf16(rng, (E, C, D), dev),
            (_bf16(rng, (E, D, F), dev).float() / D ** 0.5).to(torch.bfloat16),
            _bf16(rng, (E, C, F), dev),
            torch.tensor(rows, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("E,C,D,F,full", GROUPED_BWD_CASES)
def test_grouped_backward_kernels_match_plain(dev, E, C, D, F, full):
    """The dX and dW kernels against their plain versions on the same bf16
    inputs and, together, against autograd through ``ref.grouped_mvm`` in
    f32, within TOL and GRAD_REL; dead rows of dX and the dW of an expert
    with no rows are zeros (dY and x are not zero there); one launch each;
    bit-for-bit repeatable (no atomics); ``rows=None`` (all C) for both."""
    from repro_torch.kernels import ref
    x, w, dy, rows = _grouped_bwd_inputs(dev, E, C, D, F, full=full)
    n0 = (gm.grouped_mvm_bwd_dx.launches, gm.grouped_mvm_bwd_dw.launches)
    dx = gm.grouped_mvm_bwd_dx(dy, w, rows)
    dw = gm.grouped_mvm_bwd_dw(x, dy, rows)
    assert (gm.grouped_mvm_bwd_dx.launches - n0[0],
            gm.grouped_mvm_bwd_dw.launches - n0[1]) == (1, 1)
    assert dx.shape == (E, C, D) and dw.shape == (E, D, F)
    _close_grad(dx, ref.grouped_mvm_bwd_dx(dy, w, rows))
    _close_grad(dw, ref.grouped_mvm_bwd_dw(x, dy, rows))
    xf, wf = (t.float().requires_grad_() for t in (x, w))
    ref.grouped_mvm(xf, wf, rows).backward(dy.float())
    _close_grad(dx, xf.grad)
    _close_grad(dw, wf.grad)
    dead = torch.arange(C, device=dev)[None, :] >= rows[:, None]
    assert not dx[dead].any() and not dw[rows == 0].any()
    assert torch.equal(gm.grouped_mvm_bwd_dx(dy, w, rows), dx)
    assert torch.equal(gm.grouped_mvm_bwd_dw(x, dy, rows), dw)
    full_dx = gm.grouped_mvm_bwd_dx(dy, w)
    _close_grad(full_dx, ref.grouped_mvm_bwd_dx(dy, w))
    full_dw = gm.grouped_mvm_bwd_dw(x, dy)
    _close_grad(full_dw, ref.grouped_mvm_bwd_dw(x, dy))


def test_grouped_autograd_on_the_card(dev):
    """``ops.grouped_mvm`` and ``ops.moe_expert_ffn`` under autograd on the
    card: the forward kernel and one dX and one dW launch a product, the
    gradients of autograd through the plain products on the same bf16
    inputs (each product f32 with one rounding, as the kernels) within
    TOL and GRAD_REL; an input that needs no gradient costs no launch;
    the backward kernels take bf16 only."""
    E, C, D, F = 8, 200, 256, 136
    x, w, dy, rows = _grouped_bwd_inputs(dev, E, C, D, F, seed=4)
    rng = np.random.default_rng(5)
    wg, wu = w, (_bf16(rng, (E, D, F), dev).float() / D ** 0.5
                 ).to(torch.bfloat16)
    wd = (_bf16(rng, (E, F, D), dev).float() / F ** 0.5).to(torch.bfloat16)
    g = _bf16(rng, (E, C, D), dev)
    counters = (gm.grouped_mvm, gm.grouped_mvm_bwd_dx, gm.grouped_mvm_bwd_dw)
    n0 = [c.launches for c in counters]
    ts = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    ops.moe_expert_ffn(*ts, rows).backward(g)
    assert [c.launches - n for c, n in zip(counters, n0)] == [3, 3, 3]
    plain = [t.clone().requires_grad_() for t in (x, wg, wu, wd)]
    ops.moe_expert_ffn(*plain, rows, impl="ref").backward(g)
    for t, want in zip(ts, plain):
        _close_grad(t.grad, want.grad)
    n0 = [c.launches for c in counters]
    wa = w.clone().requires_grad_()
    ops.grouped_mvm(x, wa, rows).backward(dy)
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 0, 1]
    assert torch.equal(wa.grad, gm.grouped_mvm_bwd_dw(x, dy, rows))
    with pytest.raises(ValueError, match="bfloat16"):
        ops.grouped_mvm(x.float(), w.float().requires_grad_()).backward(
            dy.float())


def test_olmoe_train_step_kernels_match_the_plain_route(dev, monkeypatch):
    """olmoe-1b-7b at full width (64 experts, top-8) cut to 2 layers, B 2 x
    128 tokens, from the same f32 masters on the card: the loss and every
    leaf's gradient through the kernels (flash and grouped GEMM, forward
    and backward, remat) against the plain route, the loss within the
    bf16 TOL and each leaf within a relative Frobenius error of 2e-2; the
    kernel route launches 3 dX and 3 dW a layer, the plain route none;
    then one ``make_train_step`` step each way, the losses equal within
    TOL. A token at a routing near-tie may take another expert on one
    route than on the other: one of 256 tokens' claims moves a stacked
    expert leaf's gradient by well under the bound."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.convert import compute_view, master_params
    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe
    from repro_torch.optim import adamw_init
    from repro_torch.optim.adamw import leaves
    cfg = dataclasses.replace(get_config("olmoe-1b-7b"), num_layers=2)
    batch = {k: v.to(dev) for k, v in TokenStream(
        cfg.vocab_size, 128, 2, seed=0).batch(0).items()}
    init = master_params(moe.init_params(cfg, seed=0, device=dev))
    runs = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(ops, "_plain", lambda impl, x: True)
        n0 = (gm.grouped_mvm_bwd_dx.launches, gm.grouped_mvm_bwd_dw.launches)
        params = copy.deepcopy(init)
        flat = leaves(params)
        for t in flat:
            t.requires_grad_(True)
        loss = moe.loss_fn(cfg, compute_view(params), batch)
        grads = torch.autograd.grad(loss, flat)
        step = make_train_step(cfg, lr=1e-3, warmup=2, total=10)
        _, _, m = step(params, adamw_init(params), batch)
        runs[route] = (float(loss.detach()), grads, float(m["loss"]),
                       (gm.grouped_mvm_bwd_dx.launches - n0[0],
                        gm.grouped_mvm_bwd_dw.launches - n0[1]))
    (lk, gk, mk, nk), (lp, gp, mp, np_) = runs["kernel"], runs["plain"]
    assert nk == (2 * 3 * cfg.num_layers,) * 2 and np_ == (0, 0)
    np.testing.assert_allclose(lk, lp, rtol=2e-2)
    np.testing.assert_allclose(mk, mp, rtol=2e-2)
    for a, b in zip(gk, gp):
        assert torch.isfinite(a).all()
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 2e-2
