"""The port's Hopper kernels against their plain versions, on the card.

Marked ``cuda``: without a card every test skips (decided inside the
fixture, so every pytest worker collects the same tests). On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

bf16 in and out: kernel and plain version both round the f32 result to
bf16, so they agree within tests/test_kernels.py's bf16 TOL (2e-2).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.runtime import Engine, EngineConfig, poisson_trace

pytestmark = pytest.mark.cuda
TOL = dict(rtol=2e-2, atol=2e-2)


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


@pytest.mark.parametrize("B,H,KV,S,T,dh,causal,window", [
    (1, 4, 4, 128, 128, 128, True, 0),
    (2, 4, 2, 130, 130, 128, True, 0),
    (1, 8, 2, 64, 130, 128, True, 0),
    (2, 4, 1, 1, 77, 64, True, 0),
    (1, 4, 2, 100, 100, 64, False, 0),
    (1, 4, 4, 200, 200, 128, True, 48),
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
