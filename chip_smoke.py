#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py

Builds the Hopper kernels from src/repro_torch/kernels/csrc (nvcc, sm_90a,
into build/repro_torch/), then:

  (a) holds each kernel against its plain PyTorch version on the card at
      the main path's shapes (codeqwen1.5-7b widths), times both, and
      computes each kernel's bound from this run's inputs;
  (b) serves codeqwen1.5-7b at full width (random weights from a seed)
      through the continuous-batching engine: 8 slots, a seeded trace of
      16 requests, greedy decode in fused horizons of 32. The kernels'
      launch counters are zeroed just before and read just after, and the
      generated tokens are teacher-forced through the full-sequence
      forward to check they are its greedy choices;
  (b') profiles one decode step and one 512-token prefill: host enqueue,
      wall and device busy time, and the top kernels;
  (c) runs the static lockstep baseline on the first 8 requests.

Any failed check raises and the script exits non-zero. The last three
lines are the kernels' JSON record, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": ...}. Without a card, or without
src/repro_torch beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores
# and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 kernel vs its f32-internal plain version, both rounding the output
# to bf16: a couple of bf16 quanta at |out| ~ 1-4, as tests/test_kernels.py
TOL = dict(rtol=2e-2, atol=2e-2)


def cuda_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` in ms, from CUDA events over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare(torch, got, want, what: str) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **TOL,
                               msg=lambda m: f"{what}: {m}")
    return err


def decode_case(torch, B, KV, G, lengths, page=16, dh=128, seed=0):
    """Inputs of one paged decode call: a pool holding every row's pages
    at random page ids, dead table slots on the trash page."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = 2048 // page
    n_pages = [-(-n // page) for n in lengths]
    P = 1 + sum(n_pages) + 8
    kp = torch.randn((KV, P, page, dh), generator=gen, device=DEV
                     ).to(torch.bfloat16)
    vp = torch.randn((KV, P, page, dh), generator=gen, device=DEV
                     ).to(torch.bfloat16)
    q = torch.randn((B, KV * G, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    perm = torch.randperm(P - 1, generator=gen, device=DEV).cpu() + 1
    table = torch.zeros((B, M), dtype=torch.int32)
    used = 0
    for b, n in enumerate(n_pages):
        table[b, :n] = perm[used:used + n]
        used += n
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    args = (q, kp, vp, table.to(DEV), lens)
    live = sum(lengths)
    nbytes = (2 * live * KV * dh * 2 + 2 * q.numel() * 2
              + B * M * 4 + B * 4)
    flops = 4 * live * KV * G * dh
    return args, flops, nbytes


def flash_case(torch, B, H, KV, S, T, window, dh=128, seed=0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, S, H, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    k = torch.randn((B, T, KV, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    v = torch.randn((B, T, KV, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    # visible pairs: query row i sees keys (i + T - S - window, i + T - S]
    pairs = sum(min(T, i + T - S + 1)
                - (max(0, i + T - S - window + 1) if window else 0)
                for i in range(S))
    flops = 4 * B * H * dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    return (q, k, v), flops, nbytes


def phase_kernels(torch, ops, dec, fa):
    """(a) every kernel against its plain version, timed at main-path
    shapes. Returns the kernel records (launches filled in later)."""
    import torch.nn.functional as F

    print("== (a) kernels vs plain versions", flush=True)
    ragged = [2048, 1, 700, 0, 1333, 16, 1999, 257]   # incl. a length-0 row
    dec_err, dec_main = 0.0, None
    for name, B, KV, G in (("decode B=8 KV=32 G=1", 8, 32, 1),
                           ("decode B=8 KV=8 G=4", 8, 8, 4)):
        args, flops, nbytes = decode_case(torch, B, KV, G, ragged)
        got = ops.paged_decode_attention(*args)
        want = ops.paged_decode_attention(*args, impl="ref")
        err = compare(torch, got, want, name)
        assert torch.all(got[3] == 0), "length-0 row must yield zeros"
        dec_err = max(dec_err, err)
        ms = cuda_ms(torch, lambda: ops.paged_decode_attention(*args))
        plain = cuda_ms(torch, lambda: ops.paged_decode_attention(
            *args, impl="ref"), iters=5)
        b_ms, b_by = bound(flops, nbytes)
        print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        if dec_main is None:
            dec_main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)

    fa_err, fa_main = 0.0, None
    for name, B, H, KV, S, T, window in (
            ("flash S=T=512 H=KV=32", 1, 32, 32, 512, 512, 0),
            ("flash S=T=300 H=KV=32", 1, 32, 32, 300, 300, 0),
            ("flash S=T=512 H=32 KV=8", 1, 32, 8, 512, 512, 0),
            ("flash S=T=300 H=32 KV=8 window=100", 1, 32, 8, 300, 300, 100)):
        (q, k, v), flops, nbytes = flash_case(torch, B, H, KV, S, T, window)
        got = ops.flash_attention(q, k, v, causal=True, window=window)
        want = ops.flash_attention(q, k, v, causal=True, window=window,
                                   impl="ref")
        err = compare(torch, got, want, name)
        fa_err = max(fa_err, err)
        ms = cuda_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=True, window=window))
        plain = cuda_ms(torch, lambda: ops.flash_attention(
            q, k, v, causal=True, window=window, impl="ref"), iters=5)
        lib = None
        if not window:      # one PyTorch call computing the same function
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        b_ms, b_by = bound(flops, nbytes)
        print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms  "
              f"plain {plain:.4f} ms  sdpa {lib}  bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        if fa_main is None:
            fa_main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib)
    return [
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:172",
             counter=dec.paged_decode_attention, max_abs_err=dec_err,
             **dec_main),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:103",
             counter=fa.flash_attention, max_abs_err=fa_err, **fa_main),
    ]


def greedy_gap(torch, T, cfg, params, req) -> float:
    """Teacher-force a finished request through the full-sequence forward:
    the largest gap between a position's max logit and the logit of the
    token the engine chose there (0 when every choice was its argmax)."""
    seq = list(req.prompt) + list(req.generated)
    toks = torch.tensor([seq], dtype=torch.int32, device=DEV)
    logits = T.forward(cfg, params, {"tokens": toks})[0]
    start = len(req.prompt)
    rows = logits[start - 1:start - 1 + len(req.generated)]
    chosen = torch.tensor(req.generated, device=DEV)
    gaps = rows.max(-1).values - rows.gather(1, chosen[:, None])[:, 0]
    return gaps.max().item()


def phase_engine(torch, T, rt, cfg, params, trace, kernels):
    """(b) the full-width engine, counting the kernels' launches."""
    print("== (b) engine, codeqwen1.5-7b full width", flush=True)
    ecfg = rt.EngineConfig(num_slots=8, page_size=16, num_pages=1 + 8 * 40,
                           max_pages_per_seq=40, prefill_bucket=128,
                           greedy=True, horizon=32)
    engine = rt.Engine(cfg, params, ecfg)
    for k in kernels:
        k["counter"].launches = 0
    torch.cuda.synchronize()
    rep = engine.run(copy.deepcopy(trace))
    torch.cuda.synchronize()
    for k in kernels:
        k["launches"] = k.pop("counter").launches
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    for k in kernels:
        print(f"  launches {k['name']}: {k['launches']}")
        assert k["launches"] > 0, f"{k['name']} never ran on the main path"
    assert len(rep.completed) == len(trace)
    for r in rep.completed:
        assert not r.truncated and len(r.generated) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    n_tok = rep.new_tokens
    print(f"  decode wall {rep.decode_wall_s:.3f} s (+ first horizon "
          f"{rep.compile_wall_s:.3f} s)  prefill wall "
          f"{rep.prefill_wall_s:.3f} s  tokens/s "
          f"{summary['tokens_per_s']}  host syncs per token "
          f"{rep.host_syncs / n_tok:.4f}", flush=True)
    worst, scale = 0.0, 0.0
    for r in rep.completed[:3]:
        worst = max(worst, greedy_gap(torch, T, cfg, params, r))
    for r in rep.completed[:1]:
        seq = torch.tensor([list(r.prompt)], device=DEV)
        lg = T.forward(cfg, params, {"tokens": seq})
        assert torch.isfinite(lg).all()
        scale = lg.abs().max().item()
    print(f"  teacher-forced greedy gap {worst:.4e} (logit scale "
          f"{scale:.3e})", flush=True)
    # the engine decodes through the paged kernel, the forward through the
    # flash kernel: both round to bf16 in different places, so a choice may
    # trail the argmax by a few bf16 quanta of the logit scale, while a
    # corrupted cache would put it O(scale) away
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    return rep


def breakdown(torch, label: str, fn, steps: int = 4) -> None:
    """Where one call's time goes: host enqueue time, wall time, device
    busy time (torch.profiler's kernel time), idle share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        fn()
    enqueue = (time.monotonic() - t0) / steps
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # kernel rows only: a CPU op's row repeats its kernels' device time
    rows = [(e.key, e.self_device_time_total / 1e3 / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy = sum(ms for _, ms in rows)
    print(f"  {label}: host enqueue {enqueue * 1e3:.2f} ms  wall "
          f"{wall * 1e3:.2f} ms  device busy "
          + (f"{busy:.2f} ms  idle share {1 - busy / (wall * 1e3):.3f}"
             if busy else "not measured"), flush=True)
    for key, ms in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"    {ms:8.3f} ms  {key[:90]}")


def phase_breakdown(torch, T, cfg, params):
    """(b') one decode step at the main path's batch (8 slots, 400 live
    tokens each) and one 512-token prefill, profiled."""
    print("== (b') where the time goes", flush=True)
    B, page, M = 8, 16, 40
    state = T.init_paged_decode_state(cfg, 1 + B * M, page, device=DEV)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32,
                         device=DEV).view(B, M)
    lens = torch.full((B,), 400, dtype=torch.int32, device=DEV)
    toks = torch.zeros((B,), dtype=torch.int32, device=DEV)
    act = torch.ones((B,), dtype=torch.bool, device=DEV)
    breakdown(torch, f"decode step B={B}", lambda: T.paged_decode_step(
        cfg, params, state, toks, table, lens, act))
    prompt = {"tokens": torch.zeros((1, 512), dtype=torch.int32,
                                    device=DEV)}
    plen = torch.tensor([512], dtype=torch.int32, device=DEV)
    breakdown(torch, "prefill S=512", lambda: T.paged_prefill(
        cfg, params, prompt, plen), steps=2)


def phase_static(rt, cfg, params, trace):
    """(c) the static lockstep baseline on the first 8 requests."""
    print("== (c) static baseline, first 8 requests", flush=True)
    rep = rt.run_static(cfg, params, copy.deepcopy(trace[:8]), num_slots=8)
    print(json.dumps(rep.summary()), flush=True)
    assert len(rep.completed) == 8
    assert all(len(r.generated) == r.max_new_tokens for r in rep.completed)
    return rep


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import transformer as T
    from repro_torch import runtime as rt

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {smi}", flush=True)

    t0 = time.monotonic()
    logs = _build.build()
    print(f"== build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    kernels = phase_kernels(torch, ops, dec, fa)

    cfg = get_config("codeqwen1.5-7b")
    t0 = time.monotonic()
    params = T.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"== init_params {cfg.name}: {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    trace = rt.poisson_trace(16, mean_interarrival=4.0,
                             prompt_lens=(128, 256, 384, 512),
                             gen_lens=(32, 64, 96, 128),
                             vocab_size=cfg.vocab_size, seed=0)
    phase_engine(torch, T, rt, cfg, params, trace, kernels)
    phase_breakdown(torch, T, cfg, params)
    phase_static(rt, cfg, params, trace)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          " GiB")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
