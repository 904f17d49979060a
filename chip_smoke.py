#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (src/repro_torch) on one NVIDIA GPU.

  python3 chip_smoke.py [--parent DIR]

Builds the Hopper kernels from src/repro_torch/kernels/csrc (nvcc, sm_90a,
into build/repro_torch/), then:

  (a) holds each attention kernel against its plain PyTorch version on
      the card at the main path's shapes (codeqwen1.5-7b widths; flash
      also at olmoe-1b-7b's prefill and whisper-tiny's encoder, B 8,
      S = T = 1500, dh 64, not causal), times both with the host's
      enqueue hidden, beside ``scaled_dot_product_attention`` where one
      call computes the same function, and computes each kernel's bound
      from this run's inputs; the paged decode also at GQA groups of 4,
      7, 8 and 12 and in 1, 2, 4 and 8 splits; both also at (n)'s
      command-r-35b shapes (paged decode B 8, KV 8, G 8 over 40-page table
      rows of 129-576 tokens; flash H 64 over KV 8 at S 128, 384 and 512,
      causal); each shape's error and time go into the kernels line;
  (b) serves codeqwen1.5-7b at full width (random weights from a seed)
      through the continuous-batching engine: 8 slots, a seeded trace of
      16 requests, greedy decode in fused horizons of 32, each replayed
      from CUDA graphs. The kernels' launch counters are zeroed just
      before and read just after (one paged launch a layer a decode step,
      one flash launch a layer a prefill); the same run with every
      horizon on the eager loop must give the same tokens, ledger and
      launch counts; the paged decode kernel is timed on the lengths of
      every decode step of that run (T 640), in 1 to 10 splits and as
      planned; and the generated tokens are teacher-forced through the
      full-sequence forward to check they are its greedy choices;
  (b') profiles one decode step and one 512-token prefill: host enqueue,
      wall and device busy time, and the top kernels;
  (b'') runs one fused horizon of 32 steps on one backend's state two
      ways, the eager loop and the engine's CUDA-graph replays: host
      enqueue, wall and device busy a step and tokens/s of each; equal
      tokens, loop tensors and launch counts; the graphed horizon again
      with the card's sync check set to error;
  (c) runs the static lockstep baseline on the first 8 requests, with the
      attention kernels' launch counters zeroed just before and read just
      after: one dense decode-attention launch a layer a decode step, and
      flash at prefill only; then the entry point's lockstep static mode
      (``launch.serve`` ``run_static_mode``, part of (j+)) on the same
      params: B 8, 512-token prompts, 32 greedy steps, one dense decode
      launch a layer a step, one flash launch a layer, nothing else, and
      no plain attention called;
  (d1) holds the packed-canvas kernels (fp, fused epilogue, int8/int4
      dequant, with and without the epilogue) against their plain
      versions at full width, the tolerance printed: one codeqwen1.5-7b
      decoder layer's seven projections packed on one plane (R 25728, C
      59648, 14,176 blocks) at B 1, 8, 9, 32, 128 and 200 in bf16, int8
      and int4 (the epilogues at 8 and 128), whisper-tiny's 24
      projections (f32 at B 64, also over int8 and int4 payloads, and 32;
      bf16 at 200), and each activation on a small layout; times each against its bound and, where one
      PyTorch call computes the same function, that call (at codeqwen
      ``torch.matmul`` over the dense plane, and the per-matrix cuBLAS
      loop beside it); each case runs the kernel twice and the plain
      version twice on the same inputs and prints whether each side's
      bits repeat, and a digest of each side's first output;
  (d2) runs the packing entry point ``repro_torch.launch.pack`` on the
      card (the paper's case studies, the canvas rows and end-to-end
      passes through all four packed-canvas kernels) and its check(),
      with the packed-canvas kernels' launch counters zeroed just before
      and read just after;
  (e0) holds the grouped expert GEMM against its plain version at the
      MoE path's shapes (deepseek-v2-lite-16b: 64 experts, D 2048 / F
      1408 and back, C 8 at decode, 64 and 128 at prefill, a ragged 5,
      and a decode routed top-6 whose bound counts the touched experts),
      timed beside its bound and ``torch.bmm``;
  (e) serves deepseek-v2-lite-16b at full width and depth (random
      weights from a seed) through the engine's latent-page backend on
      (b)'s trace, with every kernel's launch counter zeroed just before
      and read just after (81 grouped launches a decode step and a
      prefill), its eager twin as in (b), and teacher-forces the
      generated tokens through the static prefill + per-token decode,
      which routes as the engine does;
  (e') profiles one deepseek decode step and one 512-token prefill, and
      runs one fused horizon with the card's sync check set to error;
  (e+) the eager-vs-graphed horizons of (b'') on deepseek, 8 steps each;
  (e'') runs the static lockstep baseline on deepseek, first 8 requests;
  (f0) holds the dense decode-attention kernel against its plain version
      at the static paths' shapes (olmoe-1b-7b B 8, KV 16, dh 128, T 640;
      codeqwen1.5-7b KV 32; GQA groups of 4, 7 (qwen2-vl-7b) and 12
      (command-r-plus); whisper-tiny's self- and cross-attention, KV 6,
      dh 64, T 1500), with ragged lengths, a length-0 row and T off the
      kernel's tile, timed beside its bound and
      ``scaled_dot_product_attention`` with a length mask, and at the
      main row with T in 1 and in 3 splits;
  (f) serves olmoe-1b-7b (GQA-MoE, 64 experts top-8) at full width and
      depth through the static path on (b)'s trace in groups of 8, with
      the kernels' launch counters zeroed just before and read just after
      (16 decode-attention launches a decode step, 48 grouped launches a
      decode step and a prefill), and checks one greedy static decode
      against the full forward teacher-forced with its tokens;
  (f') profiles one olmoe static decode step and one 512-token prefill;
  (g) serves whisper-tiny at full width through the static path (frames
      from the seed, prompts 16-64, generations 64-224), counting 8
      decode-attention launches a step (4 self, 4 cross), and checks it
      as (f) does;
  (h) serves qwen2-vl-7b (vlm, M-RoPE) at full width and depth through
      the engine on (b)'s settings and trace, each request carrying 4
      patch embeddings drawn by ``vlm_extras_fn``, prefix sharing asked
      for and refused by the backend: every kernel counter zeroed just
      before and read just after (28 paged-decode launches a decode
      step, 28 flash launches a prefill, nothing else), its eager twin
      as in (b), and the tokens teacher-forced through the static path
      with the same patches;
  (h') profiles one qwen2-vl-7b decode step and one 512-token prefill;
  (h'') the eager-vs-graphed horizons of (b'') on qwen2-vl-7b;
  (h+) serves the same 16 requests through the static path, counting one
      dense decode launch a layer a step and flash at prefill only;
  (i) serves rwkv6-7b (ssm) at full width cut to 12 layers (``SSM_LAYERS``;
      (o) serves it at full depth) through the engine's
      recurrent backend (no pages; a constant state per slot, written in
      place at admission; fused horizons replayed from the one-step graph
      over a dummy one-row table) on (b)'s settings and trace: every
      request completes, no kernel of the eight launches, the report
      counts the state as ``slot_state_bytes`` in ``kv_bytes_peak``, the
      eager twin as in (b), and the same requests served one at a time
      give the same tokens;
  (i') profiles one rwkv6-7b decode step and one 512-token prefill and
      gives the WKV routine's share of each one's device time;
  (i'') the eager-vs-graphed horizons of (b'') on rwkv6-7b's state, 8
      steps each;
  (j) serves recurrentgemma-9b (hybrid: RG-LRU recurrence and local
      attention over a 2,048-token window, MQA at head dim 256) at full
      width cut to 14 layers (``HYBRID_LAYERS``; (o) serves it at full
      depth) through the engine's hybrid backend on (b)'s
      settings with 129-row tables (the window ring) and (b)'s trace plus
      a 2,560-token prompt and a 1,984-token one that generates past the
      window: every kernel counter zeroed just before and read just after
      (none of the eight launches: the attention is torch ops), every
      request complete, at most 129 pages a request, pages freed on ring
      wraps and none left at the end (the engine's leak check), the eager
      twin as in (b), and five requests' tokens (the first three and the
      two past the window) teacher-forced through the full forward;
  (j') profiles one recurrentgemma decode step and one 512-token
      prefill, and gives the RG-LRU scan's share of each;
  (j'') the eager-vs-graphed horizons of (b'') on its ring, 8 steps, and
      the graphed step's device time beside its bound;
  (j+) runs the entry point ``launch.serve --arch recurrentgemma-9b
      --full --mode static --batch 8 --prompt-len 512 --gen 32`` (the
      reference's lockstep static mode; codeqwen1.5-7b's run is in (c));
  (k) serves a model zoo from one card through ``PooledEngine``, every
      earlier phase's params, graphs and pools freed first:
      codeqwen1.5-7b (share 2), deepseek-v2-lite-16b and rwkv6-7b at full
      width and depth (61.85 GB of bf16 weights; paged, latent-page and
      recurrent backends, each tenant's horizons replayed from its own
      CUDA graphs), the reference's auto budget and the H100 reload clock,
      on a seeded 24-request trace by share (prompts 128-512, generations
      32-128), (b)'s engine settings: reload-aware and round-robin at
      model granularity, then reload-aware with layer streaming through
      the device DMA channel (pinned host memory to the card on a stream
      of its own) with every kernel counter zeroed just before and read
      just after, per tenant (one paged launch a codeqwen layer a decode
      step, one flash launch a codeqwen layer a prefill, 81 grouped
      launches a deepseek decode step and prefill, none for rwkv6, no
      plain version called), and its eager twin (same tokens, ledger and
      launches). Asserts bench_serve's pool claims (reload-aware ahead of
      round-robin on tokens/step with fewer reload bytes, layer streaming
      with fewer stall steps, the same token count), measured DMA stalls
      within the modeled ones, and three codeqwen requests as greedy
      choices of the full forward; prints the pinned host-to-device rate
      beside the clock's constant and the peak card memory;
  (k') two replicated pools on (k)'s params (the weights held once) on a
      seeded 24-request diurnal trace, queues capped at 8: demand
      placement at one copy a model against mirror (ahead on tokens/step
      with fewer reload bytes), the chaos run ``kill@10:r1,dma@2:r0x4/100``
      at two copies (no request lost, a failover and re-admissions, p99
      queue age within 10x the clean run's), every request the same
      token count and each differing stream greedy-consistent; then the
      entry points ``launch.serve.run_pool`` and ``run_fleet`` on the same
      params;
  (n) the mesh slice's full-width path on one card: ``launch.serve
      --mesh pod`` must raise, naming its 256 ranks; then ``launch.serve``'s
      ``--mesh host --full --arch command-r-35b --greedy`` pieces (the
      1x1 ``DeviceMesh`` on nccl, installed for the model code, its shape
      and backend printed; the params drawn through ``serve.init_params``
      from the seed) serve command-r-35b at full width and depth (40
      layers, 60.31 GiB of bf16, GQA 64/8, vocabulary 256,000), every
      earlier phase's params freed first, through the engine on (b)'s
      settings (8 slots, page 16, fused horizons of 32 replayed from CUDA
      graphs) and a seeded 8-request trace (prompts 128-512, generations
      32-64, greedy): every kernel counter zeroed just before and read
      just after (40 paged-decode launches a decode step, 40 flash
      launches a prefill, nothing else, no plain attention called), its
      eager twin as in (b), three requests teacher-forced through the
      full forward, the peak card memory; then (n') the eager-vs-graphed
      horizons of (b'') at 8 steps and the graphed step's device time
      beside its bytes bound, computed from this run's weights and cache;
  (o) the mesh slice of the other families: ``launch.serve.main --mesh
      host --full --greedy --batch 4 --requests 4`` (the 1x1 nccl mesh)
      serves qwen2-vl-7b, rwkv6-7b and recurrentgemma-9b through the
      engine (prompts 256-512, recurrentgemma's 1,024-2,048 for its
      window ring, generations 32-128) and whisper-tiny static (B 4 x
      512 + 128), each at full width and depth from the seed, every
      kernel counter zeroed just before and read just after (qwen2-vl's
      28 paged-decode launches a decode step and 28 flash a prefill,
      whisper's 8 dense decode a step and 12 flash at its prefill, none
      for rwkv6 and recurrentgemma); the same params and prompts through
      the unsharded path (no mesh installed) must give the same tokens
      bit for bit; each run's wall and tokens/s or ms a step printed
      beside the card's name and power limit; (o') ``launch.train.main
      --mesh host`` trains rwkv6-7b at full width cut to 2 layers for 3
      steps of B 8 x 512, and its step-1 loss must equal the same cut
      run's without a mesh (``build_config``) bit for bit;
  (p) the mesh slice of the MoE family (expert-parallel experts,
      head-parallel MLA, group-local dispatch) the same way: olmoe-1b-7b
      static (B 4 x 512 + 128: 16 flash launches at its prefill, 16
      dense decode a step, 48 grouped products a step and at the
      prefill) and deepseek-v2-lite-16b on the engine (4 slots, prompts
      256-512, generations 32-128: 81 grouped products a decode step and
      a prefill), each at full width and depth, the card freed between
      them, each against its unsharded twin bit for bit, tokens/s beside
      the card's name and power limit;
  (l0) holds the flash backward (the row-dot pre-pass, the dK/dV kernel
      and the dQ kernel) against its plain versions on the card, each
      launch on the same inputs and the whole against autograd through
      ``ref.mha_attention`` in f32, and the forward's log-sum-exp output,
      at olmo-1b's training shape (B 8, H = KV 16, S = T 512, dh 128,
      causal), qwen2-vl-7b's G 7 (H 28, KV 4) and whisper-tiny's cross
      attention (H 6, S 448 against T 1,500, dh 64, not causal); times
      each launch and the whole beside its bound, the plain versions and
      the SDPA backward (its forward and backward less its forward);
  (l) trains olmo-1b at full width and depth (1.18 B parameters, f32
      masters and AdamW state, remat) through the entry point
      ``repro_torch.launch.train.main --mesh host`` (a real 1x1
      DeviceMesh on nccl, its shape and backend printed, after ``--mesh
      pod`` has raised on one card) for 20 steps of B 8 x 512 tokens
      with a checkpoint at step 12: the loss must fall and every step's
      gradient norm be finite; every kernel counter zeroed just before and
      read just after (32 flash forward launches a step, the recomputed
      blocks' included, 16 of each backward launch, nothing else), no
      plain attention called; ``main`` again resumes from step 12 and its
      step 13 loss equals the first run's bit for bit; then one step's
      breakdown (host enqueue against device busy, ms/step, tokens/s,
      model FLOPs over 989 TFLOP/s, peak memory), and the digest of each
      gradient leaf of step 1, so that two calls compare leaf by leaf;
  (m0) holds the grouped GEMM's backward kernels (dX = dY w^T and dW =
      x^T dY over each expert's live rows) against their plain versions
      and, together, against autograd through ``ref.grouped_mvm`` in f32,
      within TOL and GRAD_REL, at olmoe-1b-7b's training shapes (64
      experts, C 640, D 2048 -> F 1024 and the down product),
      deepseek-v2-lite-16b's (C 512, F 1408) and a C of 60, rows from a
      seeded routing with one expert that has none; times each launch
      beside its bound (live rows only), its TFLOP/s over the live rows,
      the plain version, ``torch.bmm``'s product on the same inputs and,
      with ``--parent``, the parent tree's dX and dW kernels;
  (m) trains olmoe-1b-7b at full width cut to 4 layers (1.88 B
      parameters) for 10 steps and deepseek-v2-lite-16b cut to 2 layers
      for 3 steps, B 8 x 512, through ``launch.train.build_config`` and
      ``make_train_step`` (remat): every kernel counter zeroed just before
      and read just after (per layer and step 6 grouped forward, 3 dX, 3
      dW launches, and olmoe's flash as in (l)), no plain version called,
      every loss and gradient norm finite, olmoe's loss falling, and
      olmoe's step 1 run again equal bit for bit (loss, gradient norm and
      every leaf's digest); then one step's breakdown of each.

The script prints the seconds of each phase as it ends, and its total.
The checkpoints of (l) go to a temporary directory under build/ beside
the script and are removed.
``--parent DIR`` names an unpacked checkout of an earlier commit: its
attention kernels, packed canvas and grouped GEMM are built into
DIR/build and timed in the same call beside this tree's, at (a)'s,
(d1)'s, (e0)'s, (f0)'s and (m0)'s shapes (an earlier kernel only where
it has an instance for G, the grouped GEMM's forward only where every
row is live, and its backward where the parent has one). With it, (c+)
also times the host's share of the one-rank model code of both trees in
turns (parent, this, this, parent) on codeqwen1.5-7b's params: an eager
fused horizon of 8 engine steps and a static decode step.

Any failed check raises and the script exits non-zero. The last three
lines are the kernels' JSON record, the card's name and power limit from
nvidia-smi, and {"ok": true, "device": ...}. Without a card, or without
src/repro_torch beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
DEV = "cuda"

# peak rates of one H100 SXM (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# bf16 kernel vs its f32-internal plain version, both rounding the output
# to bf16: a couple of bf16 quanta at |out| ~ 1-4, as tests/test_kernels.py
TOL = dict(rtol=2e-2, atol=2e-2)


def cuda_ms(torch, fn, iters=20, warmup=3, hide_host=False):
    """Mean device time of ``fn`` in ms, from CUDA events over ``iters``.
    ``hide_host``: the card first sleeps ~50 ms while the host enqueues
    every launch, so a call whose host overhead exceeds its device time
    is timed by the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hide_host:
        torch.cuda._sleep(100_000_000)      # cycles: ~50 ms at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float,
          peak_flops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare(torch, got, want, what: str, tol=None) -> float:
    err = (got.float() - want.float()).abs().max().item()
    torch.testing.assert_close(got.float(), want.float(), **(tol or TOL),
                               msg=lambda m: f"{what}: {m}")
    return err


# a gradient's relative Frobenius error, ||got - want|| / ||want||: beside
# TOL, which is about the size of a typical dK or dV value at whisper's
# 448 x 1,500 cross attention, so that a gradient a few percent off fails
GRAD_REL = 1e-2


def compare_grad(torch, got, want, what: str) -> tuple[float, float]:
    """``compare`` within TOL, and the relative Frobenius error within
    GRAD_REL; returns (max abs error, relative error)."""
    err = compare(torch, got, want, what)
    g, w = got.float(), want.float()
    rel = (torch.linalg.vector_norm(g - w)
           / torch.linalg.vector_norm(w)).item()
    assert rel <= GRAD_REL, \
        f"{what}: relative Frobenius error {rel:.3e} > {GRAD_REL}"
    return err, rel


def decode_case(torch, B, KV, G, lengths, page=16, dh=128, seed=0, T=2048):
    """Inputs of one paged decode call: a pool holding every row's pages
    at random page ids, dead table slots on the trash page; a table row
    holds T tokens."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    M = T // page
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


def flash_case(torch, B, H, KV, S, T, window, dh=128, causal=True, seed=0):
    gen = torch.Generator(device=DEV).manual_seed(seed)
    q = torch.randn((B, S, H, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    k = torch.randn((B, T, KV, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    v = torch.randn((B, T, KV, dh), generator=gen, device=DEV
                    ).to(torch.bfloat16)
    # visible pairs: query row i sees keys (i + T - S - window, i + T - S]
    # (causal), or all T from the window's start
    pairs = sum(max(0, (min(T, i + T - S + 1) if causal else T)
                    - (max(0, i + T - S - window + 1) if window else 0))
                for i in range(S))
    flops = 4 * B * H * dh * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 2
    return (q, k, v), flops, nbytes


def load_parent(path):
    """The kernels' ops of an earlier checkout at ``path``, imported as a
    package of their own (their libraries build into path/build), or
    None."""
    if path is None:
        return None
    root = Path(path).resolve() / "src" / "repro_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", root / "__init__.py",
        submodule_search_locations=[str(root)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_repro_torch"] = mod
    spec.loader.exec_module(mod)
    build = importlib.import_module("parent_repro_torch.kernels._build")
    build.build(["paged_decode_attention", "flash_attention", "grouped_mvm",
                 "packed_canvas"])
    return importlib.import_module("parent_repro_torch.kernels.ops")


# (label, B, KV, G, lengths, T) of the paged decode kernel: rows ragged to
# 2,048 tokens (a length-0 row third), the first at codeqwen1.5-7b's widths
# (the main row), then GQA groups of 4, 7 (qwen2-vl-7b), 8 (command-r-35b)
# and 12 (command-r-plus); then the engine's decode step of (b') (8 x 400
# tokens in 40-page table rows) and one of (n) at command-r-35b's widths
# (rows ragged over (n)'s 129-576 tokens in 40-page table rows)
RAGGED = [2048, 1, 700, 0, 1333, 16, 1999, 257]
PAGED_SHAPES = (("decode B=8 KV=32 G=1", 8, 32, 1, RAGGED, 2048),
                ("decode B=8 KV=8 G=4", 8, 8, 4, RAGGED, 2048),
                ("decode B=8 KV=4 G=7", 8, 4, 7, RAGGED, 2048),
                ("decode B=8 KV=8 G=8", 8, 8, 8, RAGGED, 2048),
                ("decode B=8 KV=8 G=12", 8, 8, 12, RAGGED, 2048),
                ("decode B=8 KV=32 G=1 engine step 8 x 400 of 640", 8, 32, 1,
                 [400] * 8, 640),
                ("decode B=8 KV=8 G=8 (n) engine step 129-576 of 640", 8, 8,
                 8, [576, 129, 300, 512, 160, 450, 237, 388], 640))


# (label, B, H, KV, S, T, window, dh, causal) of the flash kernel; the first
# is codeqwen1.5-7b's 512-token prefill (the main row); (n)'s prefills of
# command-r-35b (G 8) at its prompt buckets 128, 384 and 512 follow
FLASH_SHAPES = (
    ("flash S=T=512 H=KV=32", 1, 32, 32, 512, 512, 0, 128, True),
    ("flash S=T=300 H=KV=32", 1, 32, 32, 300, 300, 0, 128, True),
    ("flash S=T=512 H=32 KV=8", 1, 32, 8, 512, 512, 0, 128, True),
    ("flash S=T=300 H=32 KV=8 window=100", 1, 32, 8, 300, 300, 100, 128,
     True),
    ("flash olmoe prefill S=T=512 H=KV=16", 1, 16, 16, 512, 512, 0, 128,
     True),
    ("flash whisper encoder B=8 S=T=1500 H=KV=6 dh=64", 8, 6, 6, 1500, 1500,
     0, 64, False),
    ("flash (n) S=T=128 H=64 KV=8", 1, 64, 8, 128, 128, 0, 128, True),
    ("flash (n) S=T=384 H=64 KV=8", 1, 64, 8, 384, 384, 0, 128, True),
    ("flash (n) S=T=512 H=64 KV=8", 1, 64, 8, 512, 512, 0, 128, True),
)


def phase_kernels(torch, ops, dec, fa, parent=None):
    """(a) every attention kernel against its plain version, timed at
    main-path shapes with the host hidden (and the parent's kernel, if
    given). Returns the kernel records (launches filled in later), each
    with every shape's error and time under ``shapes``."""
    import torch.nn.functional as F

    print("== (a) kernels vs plain versions", flush=True)
    dec_err, dec_main, dec_shapes = 0.0, None, []
    for name, B, KV, G, lengths, T in PAGED_SHAPES:
        args, flops, nbytes = decode_case(torch, B, KV, G, lengths, T=T)
        got = ops.paged_decode_attention(*args)
        want = ops.paged_decode_attention(*args, impl="ref")
        err = compare(torch, got, want, name)
        for b, n in enumerate(lengths):
            if n == 0:
                assert torch.all(got[b] == 0), "length-0 row must be zeros"
        dec_err = max(dec_err, err)
        ms = cuda_ms(torch, lambda: ops.paged_decode_attention(*args),
                     iters=50, hide_host=True)
        plain = cuda_ms(torch, lambda: ops.paged_decode_attention(
            *args, impl="ref"), iters=5)
        b_ms, b_by = bound(flops, nbytes)
        # T = M * page cut into 1 .. 8 chunks: what the plan's choice costs
        q, kp, vp, table, lens = args
        qk = q.view(B, KV, G, q.shape[-1])
        sweep = "  ".join(
            "%d: %.4f" % (n, cuda_ms(torch, lambda n=n: dec.paged_decode_attention(
                qk, kp, vp, table, lens, splits=n), iters=50, hide_host=True))
            for n in (1, 2, 4, 8))
        old = ""
        if parent is not None and G in (1, 2, 4, 8):
            old = "  parent %.4f ms" % cuda_ms(
                torch, lambda: parent.paged_decode_attention(*args),
                iters=50, hide_host=True)
        plan, _ = dec.split_plan(B, KV, G, T,
                                 max_tiles=dec.PAGED_CHUNK_TILES)
        print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms "
              f"({plan} splits; {ms / KV:.5f} ms a kv head){old}  plain "
              f"{plain:.4f} ms  bound {b_ms:.4f} ms ({b_by})\n"
              f"    splits -> ms  {sweep}", flush=True)
        dec_shapes.append(dict(shape=name, max_abs_err=err, ms=ms))
        if dec_main is None:
            dec_main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None)

    fa_err, fa_main, fa_shapes = 0.0, None, []
    for name, B, H, KV, S, T, window, dh, causal in FLASH_SHAPES:
        (q, k, v), flops, nbytes = flash_case(torch, B, H, KV, S, T, window,
                                              dh, causal)
        kw = dict(causal=causal, window=window)
        got = ops.flash_attention(q, k, v, **kw)
        want = ops.flash_attention(q, k, v, impl="ref", **kw)
        err = compare(torch, got, want, name)
        fa_err = max(fa_err, err)
        ms = cuda_ms(torch, lambda: ops.flash_attention(q, k, v, **kw),
                     iters=50, hide_host=True)
        plain = cuda_ms(torch, lambda: ops.flash_attention(
            q, k, v, impl="ref", **kw), iters=5)
        lib = None
        if not window:      # one PyTorch call computing the same function
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != KV), iters=50,
                hide_host=True)
        old = ""
        if parent is not None:
            old = "  parent %.4f ms" % cuda_ms(
                torch, lambda: parent.flash_attention(q, k, v, **kw),
                iters=50, hide_host=True)
        b_ms, b_by = bound(flops, nbytes)
        sdpa = "none" if lib is None else f"{lib:.4f} ms"
        print(f"  {name}: max_abs_err {err:.3e}  kernel {ms:.4f} ms{old}  "
              f"plain {plain:.4f} ms  sdpa {sdpa}  bound {b_ms:.4f} ms "
              f"({b_by})", flush=True)
        fa_shapes.append(dict(shape=name, max_abs_err=err, ms=ms))
        if fa_main is None:
            fa_main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib)
        del q, k, v, got, want
    return [
        dict(name="paged_decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:172",
             counter=dec.paged_decode_attention, max_abs_err=dec_err,
             **dec_main, shapes=dec_shapes),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:103",
             counter=fa.flash_attention, max_abs_err=fa_err, **fa_main,
             shapes=fa_shapes),
    ]


def greedy_gap(torch, model, cfg, params, req) -> float:
    """Teacher-force a finished request through the full-sequence forward:
    the largest gap between a position's max logit and the logit of the
    token the engine chose there (0 when every choice was its argmax)."""
    seq = list(req.prompt) + list(req.generated)
    toks = torch.tensor([seq], dtype=torch.int32, device=DEV)
    logits = model.forward(cfg, params, {"tokens": toks})[0]
    start = len(req.prompt)
    rows = logits[start - 1:start - 1 + len(req.generated)]
    chosen = torch.tensor(req.generated, device=DEV)
    gaps = rows.max(-1).values - rows.gather(1, chosen[:, None])[:, 0]
    return gaps.max().item()


def engine_config(rt, **kw):
    """Every engine phase's settings: 8 slots, page 16, 40-page table
    rows, prefill bucket 128, greedy, fused horizons of 32; ``kw``
    overrides (the hybrid ring's 129-row tables)."""
    return rt.EngineConfig(**{**dict(
        num_slots=8, page_size=16, num_pages=1 + 8 * 40,
        max_pages_per_seq=40, prefill_bucket=128, greedy=True, horizon=32),
        **kw})


def engine_trace(rt, cfg, **kw):
    """(b)'s seeded Poisson trace: 16 requests, prompts 128-512,
    generations 32-128."""
    return rt.poisson_trace(16, mean_interarrival=4.0,
                            prompt_lens=(128, 256, 384, 512),
                            gen_lens=(32, 64, 96, 128),
                            vocab_size=cfg.vocab_size, seed=0, **kw)


def phase_engine(torch, T, rt, cfg, params, trace, kernels):
    """(b) the full-width engine, counting the kernels' launches."""
    print("== (b) engine, codeqwen1.5-7b full width", flush=True)
    ecfg = engine_config(rt)
    engine = rt.Engine(cfg, params, ecfg)
    for k in kernels:
        k["counter"].launches = 0
    rep, rise = run_counted(torch, engine, trace)
    for k in kernels:
        k["launches"] = k.pop("counter").launches
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    for k in kernels:
        print(f"  launches {k['name']}: {k['launches']}")
        assert k["launches"] > 0, f"{k['name']} never ran on the main path"
    counts = {k["name"]: k["launches"] for k in kernels}
    # one paged launch a layer a decode step (graph replays count theirs),
    # one flash launch a layer a prefill
    assert counts["paged_decode_attention"] == \
        cfg.num_layers * rep.decode_steps, counts
    assert counts["flash_attention"] == \
        cfg.num_layers * rep.prefill_calls, counts
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    print_rates(rep, summary)
    steps = eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    from repro_torch.kernels import decode_attention as dec
    paged_at_run_lengths(torch, dec, cfg, steps)
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


def finish_check(rep, trace, cfg) -> None:
    """Every request of ``trace`` completed at its budget, with tokens in
    the vocabulary."""
    assert len(rep.completed) == len(trace)
    for r in rep.completed:
        assert not r.truncated and len(r.generated) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.generated)


def print_rates(rep, summary) -> None:
    print(f"  decode wall {rep.decode_wall_s:.3f} s (+ first horizon "
          f"{rep.compile_wall_s:.3f} s)  prefill wall "
          f"{rep.prefill_wall_s:.3f} s  tokens/s {summary['tokens_per_s']}"
          f"  host syncs per token {rep.host_syncs / rep.new_tokens:.4f}",
          flush=True)


# the engine report's ledger: what a graphed run must share with an eager one
LEDGER = ("decode_steps", "slot_steps", "useful_slot_steps", "prefill_calls",
          "prefill_tokens", "preemptions", "peak_live_pages",
          "device_dispatches", "host_syncs", "page_table_upload_bytes",
          "new_tokens")


def run_counted(torch, engine, trace):
    """``engine.run`` on a copy of ``trace``: the report and the rise of
    every kernel wrapper's launch counter."""
    from repro_torch.kernels import ops
    counters = ops.launch_counters()
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    rep = engine.run(copy.deepcopy(trace))
    torch.cuda.synchronize()
    return rep, {c.__name__: c.launches - b for c, b in zip(counters, before)}


def eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise) -> list:
    """The same engine run again with every fused horizon through the
    eager loop (``decode_eager``) in place of the graph replays: the same
    tokens, ledger and launch counts as the graphed run ``rep`` / ``rise``,
    and its decode wall and tokens/s beside the graphed run's. Returns the
    lengths the paged attention kernel took at each decode step (B ints,
    0 for a slot that did not decode), read from each horizon's start."""
    engine = rt.Engine(cfg, params, ecfg)
    be = engine.backend
    steps = []

    def eager(pending, lengths, remaining, table, mask, h, teacher=None):
        n, r = lengths.tolist(), remaining.tolist()
        for i in range(h):      # paged_decode_step attends lengths + 1
            steps.append([n[b] + i + 1 if mask[b] and r[b] > i else 0
                          for b in range(len(n))])
        return be.decode_eager(pending, lengths, remaining, table,
                               torch.as_tensor(mask, device=DEV), h, teacher)

    be.decode_fused = eager
    erep, erise = run_counted(torch, engine, trace)
    assert be.graph is None
    assert {r.rid: r.generated for r in erep.completed} == \
        {r.rid: r.generated for r in rep.completed}, "tokens differ"
    for f in LEDGER:
        assert getattr(erep, f) == getattr(rep, f), f
    assert erise == rise, (erise, rise)
    print(f"  eager twin: same tokens, ledger and launches; decode wall "
          f"{erep.decode_wall_s:.3f} s against {rep.decode_wall_s:.3f} s "
          f"graphed, tokens/s {erep.summary()['tokens_per_s']} against "
          f"{rep.summary()['tokens_per_s']}", flush=True)
    return steps


def paged_at_run_lengths(torch, dec, cfg, steps, M=40, page=16) -> None:
    """The paged decode kernel at the engine's own shape (codeqwen widths,
    a table of M pages of ``page`` tokens) on the lengths of every decode
    step of (b) (``steps``, from ``eager_twin``): the kernel's total time
    over those steps in 1, 2, 3, 4, 5 and 10 splits of T = M * page and
    in ``split_plan``'s choice, beside the bytes bound of those steps."""
    B = len(steps[0])
    KV, dh = cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(11)
    kp, vp = (torch.randn((KV, 1 + B * M, page, dh), generator=gen,
                          device=DEV).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((B, KV, cfg.num_heads // KV, dh), generator=gen,
                    device=DEV).to(torch.bfloat16)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32,
                         device=DEV).view(B, M)
    lens = torch.tensor(steps, dtype=torch.int32, device=DEV)
    live = int(lens.sum())
    nbytes = (2 * live * KV * dh * 2 + len(steps) * (2 * q.numel() * 2
                                                     + B * M * 4 + B * 4))
    b_ms, _ = bound(4 * live * q.shape[1] * q.shape[2] * dh, nbytes)
    n = len(steps)
    plan, _ = dec.split_plan(B, KV, q.shape[2], M * page,
                             max_tiles=dec.PAGED_CHUNK_TILES)
    times = {}
    for s in (None, 1, 2, 3, 4, 5, 10):
        times[s] = cuda_ms(torch, lambda s=s: [
            dec.paged_decode_attention(q, kp, vp, table, lens[i], splits=s)
            for i in range(n)], iters=3, warmup=1, hide_host=True) / n
    print(f"  paged kernel at this run's {n} decode steps' lengths (mean "
          f"{live / n / B:.1f} a slot, T {M * page}): a step "
          f"{times[None]:.5f} ms as planned ({plan} splits)  bound "
          f"{b_ms / n:.5f} ms\n    splits -> ms a step  "
          + "  ".join(f"{s}: {times[s]:.5f}" for s in (1, 2, 3, 4, 5, 10)),
          flush=True)


def print_graph(graph, rep) -> None:
    """The engine's fused horizons as CUDA-graph replays, beside its
    dispatch and sync counts (one each a horizon, as the reference's)."""
    assert graph is not None and graph.graphed, "the card decodes graphed"
    assert graph.horizons == rep.host_syncs
    print(f"  fused horizons {graph.horizons} (one-step graph): "
          f"{graph.replays} replays, {graph.replays / graph.horizons:.2f} a "
          f"horizon; device_dispatches {rep.device_dispatches}, host_syncs "
          f"{rep.host_syncs}", flush=True)


def device_busy(torch, fn) -> float:
    """Kernel time (ms) of one call of ``fn`` from torch.profiler, 0.0
    where the trace shows none. Only the card's activity is traced: the
    kernel rows are all either function reads, and a CPU trace of an
    eager prefill's ~10^5 launches takes minutes to process."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def breakdown(torch, label: str, fn, steps: int = 4, part=None) -> None:
    """Where one call's time goes: host enqueue time, wall time, device
    busy time (torch.profiler's kernel time), idle share, top kernels;
    ``part`` (a substring of kernel names) also prints those kernels'
    summed time and share."""
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    # kernel rows only (the card's activity alone is traced, as in
    # device_busy)
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
    if part and busy:
        mine = sum(ms for key, ms in rows if part in key)
        print(f"    {mine:8.3f} ms  every {part} kernel (share "
              f"{mine / busy:.3f} of device busy)")
    return busy


def phase_breakdown(torch, T, cfg, params, label="(b')", extras=None):
    """(b') one decode step at the main path's batch (8 slots, 400 live
    tokens each) and one 512-token prefill (with ``extras``, a batch of
    one's vlm patches), profiled."""
    print(f"== {label} where the time goes, {cfg.name}", flush=True)
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
                                    device=DEV), **(extras or {})}
    plen = torch.tensor([512], dtype=torch.int32, device=DEV)
    breakdown(torch, "prefill S=512", lambda: T.paged_prefill(
        cfg, params, prompt, plen), steps=2)


def phase_static(torch, rt, cfg, params, trace, label="(c)", attn=None,
                 n=8):
    """(c) the static lockstep baseline on the first ``n`` requests, in
    groups of 8. With ``attn`` = (decode kernel, flash kernel) wrappers,
    their counters are zeroed just before and read just after: one decode
    launch a layer a decode step, flash at prefill only."""
    print(f"== {label} static baseline, {cfg.name}, first {n} requests",
          flush=True)
    for c in attn or ():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rep = rt.run_static(cfg, params, copy.deepcopy(trace[:n]), num_slots=8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    print(json.dumps(rep.summary()), flush=True)
    print(f"  wall {wall:.3f} s  prefill wall {rep.prefill_wall_s:.3f} s  "
          f"decode wall {rep.decode_wall_s:.3f} s  decode steps "
          f"{rep.decode_steps}", flush=True)
    assert len(rep.completed) == n
    assert all(len(r.generated) == r.max_new_tokens for r in rep.completed)
    counts = tuple(c.launches for c in attn or ())
    if attn:
        dec_n, fa_n = counts
        print(f"  launches decode_attention: {dec_n}  flash_attention: "
              f"{fa_n}", flush=True)
        assert dec_n == cfg.num_layers * rep.decode_steps, dec_n
        assert fa_n == cfg.num_layers * rep.prefill_calls, fa_n
    return rep, counts


# f32 kernel vs its f32 plain version: summation order only (as
# tests/test_kernels.py's f32 TOL)
TOL_F32 = dict(rtol=1e-4, atol=2e-4)


def codeqwen_layer_mats(WM, cfg):
    """One decoder layer's seven projections at the published widths:
    q/k/v share an input, gate/up share one, down (d_ff rows) folds."""
    D, F = cfg.d_model, cfg.d_ff
    return [WM("q", D, cfg.q_dim, share_group="qkv"),
            WM("k", D, cfg.kv_dim, share_group="qkv"),
            WM("v", D, cfg.kv_dim, share_group="qkv"),
            WM("o", cfg.q_dim, D),
            WM("gate", D, F, share_group="gu"),
            WM("up", D, F, share_group="gu"),
            WM("down", F, D)]


def canvas_problem(torch, mats, batch, seed):
    """Seeded weights (std 1/sqrt(rows)) and inputs drawn on the card;
    share-group members get one input."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    weights, inputs, shared = {}, {}, {}
    for m in mats:
        weights[m.name] = torch.randn((m.rows, m.cols), generator=gen,
                                      device=DEV) / m.rows ** 0.5
        x = torch.randn((batch, m.rows), generator=gen, device=DEV)
        inputs[m.name] = shared.setdefault(m.share_group, x) \
            if m.share_group else x
    return weights, inputs


def canvas_cost(torch, x, w, scales, out, G, c_blocks, bias=None,
                residual=None):
    """(flops, bytes, peak): each input read once and the output written
    once; f32 x runs at the f32 rate, bf16 x at the bf16 tensor rate."""
    B = x.shape[0]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, w, scales, out, bias, residual) if t is not None)
    nbytes += G * 4 + (c_blocks + 1) * 4          # each block's kb, run offsets
    peak = PEAK_F32_FLOPS if x.dtype == torch.float32 else PEAK_BF16_FLOPS
    return 2 * B * G * 128 * 128, nbytes, peak


def canvas_case(torch, ops, ref, label, x, w, meta, *, precision=None,
                scales=None, tol=None, library=None, parent=None, **epi):
    """One kernel call against its plain version, timed (and the parent
    tree's kernel on the same inputs, if given), with its bound."""
    def runner(o):
        if precision is None:
            return lambda impl="kernel": o.packed_canvas_matmul(
                x, w, meta, impl=impl, **epi)
        return lambda impl="kernel": o.packed_canvas_matmul_dq(
            x, w, scales, meta, precision=precision, impl=impl, **epi)
    run = runner(ops)
    got = run()
    want = run("ref")
    again, plain_again = run(), run("ref")
    torch.cuda.synchronize()
    assert torch.isfinite(got).all(), f"{label}: non-finite output"
    repeats = (torch.equal(got, again), torch.equal(want, plain_again))
    print(f"  {label}: bits repeat: kernel {repeats[0]}, plain "
          f"{repeats[1]}; digests kernel {digest(torch, got)} plain "
          f"{digest(torch, want)}", flush=True)
    tol = tol or (TOL if x.dtype == torch.bfloat16 else TOL_F32)
    err = compare(torch, got, want, label, tol)
    # device times: the host's enqueue of a launch (tensor maps, plan
    # lookup, ctypes) can exceed a small layout's kernel
    ms = cuda_ms(torch, run, hide_host=True)
    old = None
    if parent is not None:
        old_run = runner(parent)
        compare(torch, old_run(), want, f"{label} (parent)", tol)
        old = cuda_ms(torch, old_run, hide_host=True)
    plain = cuda_ms(torch, lambda: run("ref"), iters=5, hide_host=True)
    lib = (cuda_ms(torch, library, iters=10, hide_host=True) if library
           else None)
    G, c_blocks = meta.shape[1], got.shape[1] // 128
    flops, nbytes, peak = canvas_cost(torch, x, w, scales, got, G, c_blocks,
                                      epi.get("bias"), epi.get("residual"))
    b_ms, b_by = bound(flops, nbytes, peak)
    lib_txt = "none" if lib is None else f"{lib:.4f} ms"
    old_txt = "" if old is None else f"  parent {old:.4f} ms"
    print(f"  {label}: max_abs_err {err:.3e} (rtol {tol['rtol']:g}, atol "
          f"{tol['atol']:g})  kernel {ms:.4f} ms{old_txt}  plain "
          f"{plain:.4f} ms  library {lib_txt}  bound {b_ms:.4f} ms "
          f"({b_by}, {nbytes / 1e6:.1f} MB)", flush=True)
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, max_abs_err=err, repeats=repeats)


def digest(torch, t) -> str:
    """A short digest of ``t``'s bits, to compare outputs across calls."""
    import hashlib
    return hashlib.sha1(t.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:12]


# (d1)'s batches on the codeqwen layer: decode (1, 8), a batch off every
# tile (9, 200), the tensor cores' 128-row tile half full (32) and full
CANVAS_BATCHES = (1, 8, 9, 32, 128, 200)


def phase_canvas(torch, ops, ref, pack, WM, pack_canvas, get_config,
                 parent=None):
    """(d1) the packed-canvas kernels against their plain versions at full
    width, and (given) the parent tree's kernels on the same inputs.
    Returns the four kernels' records (launches filled in later)."""
    import numpy as np

    print("== (d1) packed-canvas kernels vs plain versions", flush=True)
    bf16 = torch.bfloat16
    cfg = get_config("codeqwen1.5-7b")
    mats = codeqwen_layer_mats(WM, cfg)
    layout = pack_canvas(mats)
    meta = layout.block_meta()
    G = layout.num_blocks
    runs = np.bincount(meta[1])
    print(f"  codeqwen1.5-7b layer: R {layout.R} C {layout.C} G {G} "
          f"({G * 128 * 128 * 2 / 1e6:.1f} MB bf16), runs {min(runs)}-"
          f"{max(runs)} blocks", flush=True)
    # published widths are 128-multiples: the plane packs losslessly
    assert layout.density == 1.0, layout.density
    bmax = max(CANVAS_BATCHES)
    weights, inputs = canvas_problem(torch, mats, bmax, seed=1)
    wb = layout.build_w_blocks(weights, dtype=bf16, device=DEV)
    xp = layout.build_x_packed(inputs, bmax, dtype=bf16, device=DEV)
    wv = layout.build_w_virtual(weights, dtype=bf16, device=DEV)
    per_matrix = {m.name: weights[m.name].to(bf16) for m in mats}
    xs = {m.name: inputs[m.name].to(bf16) for m in mats}
    gen = torch.Generator(device=DEV).manual_seed(2)
    bias = torch.randn((layout.C,), generator=gen, device=DEV).to(bf16)
    res = torch.randn((bmax, layout.C), generator=gen, device=DEV).to(bf16)
    q8, s8 = ref.quantize_blocks(wb, "int8")
    q4, s4 = ref.quantize_blocks(wb, "int4")
    rec = {k: [] for k in ("fp", "epi", "dq", "dq_epi")}
    main = {}

    for B in CANVAS_BATCHES:
        x = xp[:B].contiguous()
        loop = cuda_ms(torch, lambda: [xs[n][:B] @ w
                                       for n, w in per_matrix.items()],
                       iters=10, hide_host=True)
        rec["fp"].append(canvas_case(
            torch, ops, ref, f"fp bf16 codeqwen layer B={B} (per-matrix "
            f"cuBLAS loop, 7 calls: {loop:.4f} ms)", x, wb, meta,
            library=lambda x=x: torch.matmul(x, wv), parent=parent))
        for name, q, s in (("int8", q8, s8), ("int4", q4, s4)):
            rec["dq"].append(canvas_case(
                torch, ops, ref, f"{name} codeqwen layer B={B}", x, q, meta,
                precision=name, scales=s, parent=parent))
        if B in (8, 128):
            epi = dict(bias=bias, residual=res[:B].contiguous())
            rec["epi"].append(canvas_case(
                torch, ops, ref, f"epilogue bias+silu+residual bf16 codeqwen "
                f"B={B}", x, wb, meta, activation="silu", parent=parent,
                **epi))
            for name, q, s in (("int8", q8, s8), ("int4", q4, s4)):
                rec["dq_epi"].append(canvas_case(
                    torch, ops, ref, f"{name} epilogue bias+gelu+residual "
                    f"codeqwen B={B}", x, q, meta, precision=name, scales=s,
                    activation="gelu", parent=parent, **epi))
        if B == 8:        # the kernels record's rows: codeqwen at B = 8
            main = {"fp": rec["fp"][-1], "dq": rec["dq"][-2],
                    "epi": rec["epi"][-1], "dq_epi": rec["dq_epi"][-1]}
    del wb, xp, wv, per_matrix, xs, q8, s8, q4, s4, weights, inputs, res
    torch.cuda.empty_cache()

    # whisper-tiny's full layout: f32 at the example's batch, bf16 at a
    # batch that is a multiple of no tile
    mats = pack.whisper_mats()
    layout = pack_canvas(mats)
    meta = layout.block_meta()
    for B, dt, tol in ((64, torch.float32, TOL_F32), (32, torch.float32,
                                                      TOL_F32),
                       (200, bf16, None)):
        weights, inputs = canvas_problem(torch, mats, B, seed=3)
        wb = layout.build_w_blocks(weights, dtype=dt, device=DEV)
        xp = layout.build_x_packed(inputs, B, dtype=dt, device=DEV)
        wv = layout.build_w_virtual(weights, dtype=dt, device=DEV)
        rec["fp"].append(canvas_case(
            torch, ops, ref, f"fp {str(dt)[6:]} whisper-tiny 24 projections "
            f"(R {layout.R} C {layout.C} G {layout.num_blocks}) B={B}", xp,
            wb, meta, tol=tol, library=lambda xp=xp, wv=wv: xp @ wv,
            parent=parent))
        if B == 64:                 # f32 x over the payloads: FMA routine
            for name in ("int8", "int4"):
                q, s = ref.quantize_blocks(wb, name)
                rec["dq"].append(canvas_case(
                    torch, ops, ref, f"{name} whisper-tiny f32 x B={B}", xp,
                    q, meta, precision=name, scales=s, tol=tol,
                    parent=parent))
        if dt == torch.float32:     # the example's check, every matrix
            y = layout.gather_outputs(ops.packed_canvas_matmul(xp, wb, meta))
            err = max((y[m.name] - inputs[m.name] @ weights[m.name]).abs()
                      .max().item() for m in mats)
            print(f"  whisper f32 B={B} per-matrix max |err| {err:.3e}")
            assert err < 1e-3, err

    # each activation once, fp and dequant epilogues, on a small layout
    mats = pack.rwkv_mixer_mats()
    layout = pack_canvas(mats)
    meta = layout.block_meta()
    weights, inputs = canvas_problem(torch, mats, 8, seed=4)
    wb = layout.build_w_blocks(weights, dtype=bf16, device=DEV)
    xp = layout.build_x_packed(inputs, 8, dtype=bf16, device=DEV)
    q8, s8 = ref.quantize_blocks(wb, "int8")
    bias = torch.randn((layout.C,), generator=gen, device=DEV).to(bf16)
    res = torch.randn((8, layout.C), generator=gen, device=DEV).to(bf16)
    for act in ("none", "relu", "silu", "gelu"):
        rec["epi"].append(canvas_case(
            torch, ops, ref, f"epilogue {act} rwkv6 mixers B=8", xp, wb,
            meta, bias=bias, residual=res, activation=act))
        rec["dq_epi"].append(canvas_case(
            torch, ops, ref, f"int8 epilogue {act} rwkv6 mixers B=8", xp, q8,
            meta, precision="int8", scales=s8, bias=bias, activation=act))

    repeats = [r.pop("repeats") for rs in rec.values() for r in rs]
    moved = [sum(not r[i] for r in repeats) for i in (0, 1)]
    print(f"  (d1) bits repeat within the call: the kernel's moved in "
          f"{moved[0]} of {len(repeats)} cases, the plain version's in "
          f"{moved[1]}", flush=True)
    out = []
    for (key, name, replaces), counter in zip((
            ("fp", "packed_canvas_matmul",
             "src/repro/kernels/packed_canvas.py:196"),
            ("epi", "packed_canvas_epilogue",
             "src/repro/kernels/packed_canvas.py:216"),
            ("dq", "matmul_dq", "src/repro/kernels/dequant.py:200"),
            ("dq_epi", "matmul_dq_epilogue",
             "src/repro/kernels/dequant.py:220")), canvas_counters()):
        row = dict(main[key])
        row["max_abs_err"] = max(r["max_abs_err"] for r in rec[key])
        out.append(dict(name=name, route="cuda",
                        source="src/repro_torch/kernels/csrc/packed_canvas.cu",
                        replaces=replaces, counter=counter, **row))
    return out


def canvas_counters():
    """The four packed-canvas kernels' launch counters, in table order."""
    from repro_torch.kernels import dequant as dq
    from repro_torch.kernels import packed_canvas as pc
    return (pc._packed_canvas_matmul, pc._packed_canvas_epilogue,
            dq._matmul_dq, dq._matmul_dq_epilogue)


def phase_pack(torch, pack, kernels):
    """(d2) the packing entry point on the card, counting the launches."""
    print("== (d2) repro_torch.launch.pack on the card", flush=True)
    for k in kernels:
        k["counter"].launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rows = pack.run(DEV)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for k in kernels:
        k["launches"] = k.pop("counter").launches
    for r in rows:
        if r["name"].startswith(("pack/lm", "pack/canvas", "kernels/")):
            print("  " + json.dumps(r))
    pack.check(rows)
    print(f"  {len(rows)} rows in {wall:.2f} s, check() passed", flush=True)
    for k in kernels:
        print(f"  launches {k['name']}: {k['launches']}")
        assert k["launches"] > 0, f"{k['name']} never ran on the main path"


# --- MoE path (deepseek-v2-lite-16b) ---------------------------------------------


# (label, E, C, D, F, routed) of the grouped GEMM at deepseek-v2-lite-16b
# widths. ``routed``: x and ``rows`` from a seeded top-6 routing of the
# C = 8 decode tokens, as moe_ffn passes them (rows past each count zero,
# an expert no token chose reads nothing). The first, a routed decode
# launch, is the main path's most frequent launch (moe_ffn always passes
# ``rows``) and the kernels record's row; the all-live rows follow, where
# torch.bmm and an earlier kernel compute the same function. C = 64
# beside C = 128 shows whether a prefill launch reads the weights once.
GROUPED_SHAPES = (("routed decode top-6 of 8 tokens gate/up", 64, 8, 2048,
                   1408, True),
                  ("decode gate/up", 64, 8, 2048, 1408, False),
                  ("decode down", 64, 8, 1408, 2048, False),
                  ("prefill C=64 gate/up", 64, 64, 2048, 1408, False),
                  ("prefill gate/up", 64, 128, 2048, 1408, False),
                  ("ragged C=5 gate/up", 64, 5, 2048, 1408, False))


def routed_rows(torch, gen, E, C, k=6):
    """Kept rows per expert of C tokens that each pick k distinct experts
    (uniformly, from ``gen``): (E,) int32 counts on the card."""
    picks = torch.rand((C, E), generator=gen, device=DEV).argsort(-1)[:, :k]
    return torch.bincount(picks.flatten(), minlength=E).to(torch.int32)


def phase_grouped(torch, ops, gm, parent=None):
    """(e0) the grouped expert GEMM against its plain version at the MoE
    path's shapes, all bf16, and (given) the parent's kernel where it
    computes the same function (every row live). Returns the kernel's
    record (launches filled in by phase_moe_engine)."""
    print("== (e0) grouped expert GEMM vs plain version", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(5)
    main, err_max = None, 0.0
    for label, E, C, D, F, routed in GROUPED_SHAPES:
        x = torch.randn((E, C, D), generator=gen, device=DEV
                        ).to(torch.bfloat16)
        w = (torch.randn((E, D, F), generator=gen, device=DEV) / D ** 0.5
             ).to(torch.bfloat16)
        rows = routed_rows(torch, gen, E, C) if routed else None
        live = torch.full((E,), C, device=DEV) if rows is None else rows
        x *= (torch.arange(C, device=DEV)[None, :]
              < live[:, None])[..., None]
        got = ops.grouped_mvm(x, w, rows)
        want = ops.grouped_mvm(x, w, rows, impl="ref")
        torch.cuda.synchronize()
        assert torch.isfinite(got).all(), f"{label}: non-finite output"
        err = compare(torch, got, want, f"grouped_mvm {label}")
        err_max = max(err_max, err)
        ms = cuda_ms(torch, lambda: ops.grouped_mvm(x, w, rows))
        plain = cuda_ms(torch, lambda: ops.grouped_mvm(x, w, rows,
                                                       impl="ref"), iters=5)
        lib = cuda_ms(torch, lambda: torch.bmm(x, w))
        old = ""
        if parent is not None and rows is None:
            old = "  parent %.4f ms" % cuda_ms(
                torch, lambda: parent.grouped_mvm(x, w))
        # the weights of experts with rows, their live x rows, all of y
        touched = int((live > 0).sum())
        n_rows = int(live.sum())
        nbytes = (touched * D * F + n_rows * D + E * C * F) * 2
        b_ms, b_by = bound(2 * n_rows * D * F, nbytes)
        print(f"  {label} (E {E} C {C} D {D} F {F}; {touched} experts, "
              f"{n_rows} rows live): max_abs_err {err:.3e}  kernel "
              f"{ms:.4f} ms{old}  plain {plain:.4f} ms  torch.bmm {lib:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB)",
              flush=True)
        if main is None:
            main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
        del x, w, got, want
    return dict(name="grouped_mvm", route="cuda",
                source="src/repro_torch/kernels/csrc/grouped_mvm.cu",
                replaces="src/repro/kernels/packed_mvm.py:55",
                counter=gm.grouped_mvm, max_abs_err=err_max, **main)


def static_gap(torch, api, cfg, params, req) -> float:
    """Teacher-force a finished request through the static path at B = 1
    (prefill of the prompt, then one decode step per generated token),
    which routes every token as the engine did (the full-sequence
    forward's prefill capacity would drop generated tokens that dropless
    decode kept): the largest gap between a position's max logit and the
    logit of the token the engine chose there. A request's extras (vlm
    patches) ride along as a batch of one."""
    batch = {"tokens": torch.tensor([list(req.prompt)], device=DEV),
             **{k: torch.as_tensor(v[None], device=DEV)
                for k, v in (req.extras or {}).items()}}
    logits, state = api.prefill(cfg, params, batch,
                                len(req.prompt) + len(req.generated))
    rows = [logits[0]]
    for t in req.generated[:-1]:
        logits, state = api.decode_step(cfg, params, state,
                                        torch.tensor([t], device=DEV))
        rows.append(logits[0])
    rows = torch.stack(rows)
    chosen = torch.tensor(req.generated, device=DEV)
    gaps = rows.max(-1).values - rows.gather(1, chosen[:, None])[:, 0]
    return gaps.max().item()


def phase_moe_engine(torch, api, rt, cfg, params, trace, grouped, others):
    """(e) deepseek-v2-lite-16b through the latent-page engine, counting
    every kernel's launches; the grouped GEMM must carry every routed
    expert product (3 a layer, each decode step and each prefill)."""
    print("== (e) engine, deepseek-v2-lite-16b full width and depth",
          flush=True)
    ecfg = engine_config(rt)
    engine = rt.Engine(cfg, params, ecfg)
    assert type(engine.backend).__name__ == "LatentBackend"
    counters = [grouped["counter"], *others]
    for c in counters:
        c.launches = 0
    rep, rise = run_counted(torch, engine, trace)
    counts = {c.__name__: c.launches for c in counters}
    grouped["launches"] = grouped.pop("counter").launches
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    for name, n in counts.items():
        print(f"  launches {name}: {n}")
    per_call = 3 * cfg.num_layers
    print(f"  grouped_mvm launches per decode step and per prefill: "
          f"{per_call} (decode steps {rep.decode_steps}, prefill calls "
          f"{rep.prefill_calls})", flush=True)
    assert grouped["launches"] == per_call * (rep.decode_steps
                                              + rep.prefill_calls), counts
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    n_tok = rep.new_tokens
    print(f"  decode wall {rep.decode_wall_s:.3f} s (+ first horizon "
          f"{rep.compile_wall_s:.3f} s)  prefill wall "
          f"{rep.prefill_wall_s:.3f} s  tokens/s "
          f"{summary['tokens_per_s']}  host syncs per token "
          f"{rep.host_syncs / n_tok:.4f}  page bytes {rep.page_bytes}",
          flush=True)
    eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    worst = max(static_gap(torch, api, cfg, params, r)
                for r in rep.completed[:3])
    seq = torch.tensor([list(rep.completed[0].prompt)], device=DEV)
    lg = api.forward(cfg, params, {"tokens": seq})
    assert torch.isfinite(lg).all()
    scale = lg.abs().max().item()
    print(f"  teacher-forced greedy gap (static path) {worst:.4e} (logit "
          f"scale {scale:.3e})", flush=True)
    # engine (paged latents, batch of 8) and static path (dense cache,
    # batch of 1) round in bf16 at different places: a choice may trail
    # the argmax by a few bf16 quanta of the logit scale
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    return rep


def phase_moe_breakdown(torch, MoE, cfg, params):
    """(e') one deepseek decode step (8 slots x 400 live tokens) and one
    512-token prefill, profiled; one fused horizon of 4 steps with the
    card's sync check set to error (no host sync inside a horizon)."""
    print("== (e') where the time goes, deepseek-v2-lite-16b", flush=True)
    B, page, M = 8, 16, 40
    state = MoE.init_paged_decode_state(cfg, 1 + B * M, page, device=DEV)
    table = torch.arange(1, 1 + B * M, dtype=torch.int32,
                         device=DEV).view(B, M)
    lens = torch.full((B,), 400, dtype=torch.int32, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                         device=DEV, dtype=torch.int32)
    act = torch.ones((B,), dtype=torch.bool, device=DEV)
    breakdown(torch, f"decode step B={B}", lambda: MoE.paged_decode_step(
        cfg, params, state, toks, table, lens, act))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 512),
                                      generator=gen, device=DEV)}
    plen = torch.tensor([512], dtype=torch.int32, device=DEV)
    breakdown(torch, "prefill S=512", lambda: MoE.paged_prefill(
        cfg, params, prompt, plen), steps=2)
    rem = torch.full((B,), 4, dtype=torch.int32, device=DEV)
    lens2 = lens.clone()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = MoE.paged_decode_multi(cfg, params, state, toks.clone(), lens2,
                                     rem, table, act, 4, hmax=4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (out.cpu() >= 0).all() and (lens2.cpu() == 404).all()
    print("  fused horizon of 4 steps: no host sync inside (sync debug "
          "mode error)", flush=True)


def phase_horizon(torch, rt, ops, cfg, params, label, h=32):
    """One engine backend's state (8 slots x 400 cached tokens, random
    pool, page 16, 40 table rows, or the hybrid's 129-row window ring and
    a random recurrent state; or a random recurrent state and the dummy
    one-row table): the same fused horizon of ``h`` greedy steps
    from the same loop tensors and state through the eager loop
    (``decode_eager``) and the engine's one-step graph replays
    (``DecodeGraph``). Each is run once first (the graph captures there),
    then timed: host enqueue, wall and device busy a step, tokens/s.
    Tokens, loop tensors, state and kernel launch counts must be equal; a
    graphed horizon then runs with the card's sync check set to error.
    Returns each way's device busy ms a step (0.0 where not measured)."""
    print(f"== {label} fused horizon, eager vs graphed, {cfg.name}",
          flush=True)
    B, page = 8, 16
    M = 40 if rt.resolve_backend(cfg).paged else 1
    if cfg.family == "hybrid":          # the window ring's rows
        M = -(-cfg.recurrent.window // page) + 1
    ecfg = rt.EngineConfig(num_slots=B, page_size=page, num_pages=1 + B * M,
                           max_pages_per_seq=M, prefill_bucket=128,
                           greedy=True, horizon=h)
    be = rt.resolve_backend(cfg)(cfg, params, ecfg)
    gen = torch.Generator(device=DEV).manual_seed(9)
    state = [v for v in vars(be.state).values()
             if isinstance(v, torch.Tensor)]
    for t in state:
        t.normal_(generator=gen)
    # every horizon starts from this state (a recurrent step advances it;
    # a paged step rewrites the same rows)
    start_state = [t.clone() for t in state]
    table = torch.arange(1, 1 + B * M, dtype=torch.int32,
                         device=DEV).view(B, M) if be.paged else \
        torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    start = dict(
        pending=torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                              device=DEV, dtype=torch.int32),
        lengths=torch.full((B,), 400, dtype=torch.int32, device=DEV),
        remaining=torch.full((B,), h, dtype=torch.int32, device=DEV))
    mask = torch.ones((B,), dtype=torch.bool, device=DEV)
    graph = rt.DecodeGraph(be.decode_step, B, M, h, DEV)
    runs = {"eager": be.decode_eager, "graphed": graph.run}
    counters = ops.launch_counters()

    def horizon(run):
        t = {k: v.clone() for k, v in start.items()}
        out = run(t["pending"], t["lengths"], t["remaining"], table, mask, h)
        return out, t

    def restore():
        for t, t0 in zip(state, start_state):
            t.copy_(t0)
        torch.cuda.synchronize()

    results, step_busy = {}, {}
    for name, run in runs.items():
        restore()
        t0 = time.monotonic()
        horizon(run)                    # warm-up; the graphs capture here
        torch.cuda.synchronize()
        first = time.monotonic() - t0
        restore()
        before = [c.launches for c in counters]
        t0 = time.monotonic()
        out, t = horizon(run)
        enqueue = time.monotonic() - t0
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        rise = [c.launches - b for c, b in zip(counters, before)]
        after = [v.clone() for v in state]
        restore()
        busy = device_busy(torch, lambda run=run: horizon(run))
        results[name] = (out, t, rise, after)
        step_busy[name] = busy / h
        print(f"  {name}: first horizon {first:.2f} s; then a step: host "
              f"enqueue {enqueue * 1e3 / h:.3f} ms  wall "
              f"{wall * 1e3 / h:.3f} ms  device busy "
              + (f"{busy / h:.3f} ms" if busy else "not measured")
              + f"  tokens/s {B * h / wall:.1f}", flush=True)
    base_out, base_t, base_rise, base_after = results["eager"]
    for name, (out, t, rise, after) in results.items():
        assert torch.equal(out, base_out), f"{name}: tokens differ"
        for k, v in t.items():
            assert torch.equal(v, base_t[k]), f"{name}: {k} differs"
        assert rise == base_rise, (name, rise, base_rise)
        assert all(torch.equal(a, b) for a, b in zip(after, base_after)), \
            f"{name}: the state after the horizon differs"
    print(f"  equal tokens, loop tensors and launches "
          f"{dict(zip((c.__name__ for c in counters), base_rise))}; "
          f"{graph.replays} replays in {graph.horizons} horizons",
          flush=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        horizon(graph.run)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print("  graphed horizon: no host sync inside (sync debug mode error)",
          flush=True)
    del be, graph, runs, state, start_state, results
    torch.cuda.empty_cache()
    return step_busy


# --- static-only families (olmoe-1b-7b, whisper-tiny) ------------------------------


# (label, B, T, KV, G, dh, lengths) of the dense decode kernel; the first is
# the olmoe static path's shape at full cache (the main row)
DENSE_DECODE_SHAPES = (
    ("olmoe B=8 KV=16 T=640", 8, 640, 16, 1, 128, [640] * 8),
    ("olmoe ragged", 8, 640, 16, 1, 128, [640, 1, 0, 639, 64, 65, 300, 17]),
    ("codeqwen static KV=32 T=640", 8, 640, 32, 1, 128, [400] * 8),
    ("GQA KV=8 G=4 T=640", 8, 640, 8, 4, 128, [640, 0, 300, 64, 1, 639, 500,
                                                 17]),
    ("GQA KV=4 G=7 T=640 (qwen2-vl-7b)", 8, 640, 4, 7, 128,
     [640, 0, 300, 64, 1, 639, 500, 17]),
    ("GQA KV=8 G=12 T=640 (command-r-plus)", 8, 640, 8, 12, 128,
     [640, 0, 300, 64, 1, 639, 500, 17]),
    ("whisper self KV=6 dh=64 T=288", 8, 288, 6, 1, 64, [200] * 8),
    ("whisper cross KV=6 dh=64 T=1500", 8, 1500, 6, 1, 64, [1500] * 8),
)


def phase_dense_decode(torch, ops, dec, parent=None):
    """(f0) the dense decode-attention kernel against its plain version at
    the static paths' shapes, the cache a strided (B, T, KV, dh) layer of
    a stacked (2, B, T, KV, dh) cache, as the models pass it; timed with
    the host's enqueue hidden, beside the bytes bound, SDPA with a length
    mask and (given) the parent's kernel. Returns the kernel's record
    (launches filled in by (f))."""
    import torch.nn.functional as F

    print("== (f0) dense decode attention vs plain version", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(7)
    main, err_max = None, 0.0
    for label, B, T, KV, G, dh, lengths in DENSE_DECODE_SHAPES:
        q = torch.randn((B, KV * G, dh), generator=gen, device=DEV
                        ).to(torch.bfloat16)
        cache = torch.randn((2, B, T, KV, dh), generator=gen, device=DEV
                            ).to(torch.bfloat16)
        k, v = cache[0], cache[1]
        lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
        got = ops.decode_attention(q, k, v, lens)
        want = ops.decode_attention(q, k, v, lens, impl="ref")
        torch.cuda.synchronize()
        err = compare(torch, got, want, f"decode_attention {label}")
        for b, n in enumerate(lengths):
            if n == 0:
                assert torch.all(got[b] == 0), "length-0 row must be zeros"
        err_max = max(err_max, err)
        ms = cuda_ms(torch, lambda: ops.decode_attention(q, k, v, lens),
                     iters=50, hide_host=True)
        plain = cuda_ms(torch, lambda: ops.decode_attention(
            q, k, v, lens, impl="ref"), iters=10, hide_host=True)
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(T, device=DEV)[None, :]
                < lens[:, None])[:, None, None, :]
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, enable_gqa=G > 1), iters=50,
            hide_host=True)
        live = sum(min(n, T) for n in lengths)
        nbytes = 2 * live * KV * dh * 2 + 2 * q.numel() * 2 + B * 4
        b_ms, b_by = bound(4 * live * KV * G * dh, nbytes)
        extra = ""
        if len(set(lengths)) == 1:      # the flash kernel at S = 1 over the
            n = lengths[0]              # prefix: the static decode's old path
            fl = cuda_ms(torch, lambda: ops.flash_attention(
                q[:, None], k[:, :n], v[:, :n], causal=True), iters=50,
                hide_host=True)
            extra += f"  flash S=1 {fl:.4f} ms"
        if parent is not None and G in (1, 2, 4, 8):
            extra += "  parent %.4f ms" % cuda_ms(
                torch, lambda: parent.decode_attention(q, k, v, lens),
                iters=50, hide_host=True)
        splits, _ = dec.split_plan(B, KV, G, T)
        print(f"  {label}: max_abs_err {err:.3e}  kernel {ms:.4f} ms "
              f"({splits} splits)  plain {plain:.4f} ms  sdpa {lib:.4f} ms"
              f"{extra}  bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} "
              f"MB)", flush=True)
        if main is None:
            main = dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib)
            # the same call with T in 1 and in 3 chunks: what splitting
            # costs or buys at this shape
            qk = q.view(B, KV, G, dh)
            kt, vt = k.transpose(1, 2), v.transpose(1, 2)
            one, three = (cuda_ms(torch, lambda: dec.decode_attention(
                qk, kt, vt, lens, splits=n), iters=50, hide_host=True)
                for n in (1, 3))
            print(f"  {label}, T in 1 / 3 splits: {one:.4f} / {three:.4f} ms",
                  flush=True)
        del q, cache, k, v, got, want
    return dict(name="decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:88",
                counter=dec.decode_attention, max_abs_err=err_max, **main)


def static_consistency(torch, api, cfg, params, prompt, n_gen, extra,
                       fwd_kw) -> tuple[float, float]:
    """One prompt decoded greedily through the static path (prefill, then
    ``decode_step``, whose attention is the decode kernel), then the full
    forward (flash) over the prompt and the generated tokens: the largest
    gap between the forward's max logit and the logit of the token the
    decode chose at each position, and the forward's logit scale."""
    n = len(prompt)
    batch = {"tokens": torch.tensor([prompt], device=DEV), **extra}
    logits, state = api.prefill(cfg, params, batch, n + n_gen)
    toks = [int(logits[0].argmax())]
    for _ in range(n_gen - 1):
        logits, state = api.decode_step(
            cfg, params, state, torch.tensor([toks[-1]], device=DEV))
        toks.append(int(logits[0].argmax()))
    batch["tokens"] = torch.tensor([list(prompt) + toks[:-1]], device=DEV)
    rows = api.forward(cfg, params, batch, **fwd_kw)[0, n - 1:]
    assert torch.isfinite(rows).all()
    chosen = torch.tensor(toks, device=DEV)
    gaps = rows.max(-1).values - rows.gather(1, chosen[:, None])[:, 0]
    return gaps.max().item(), rows.abs().max().item()


def phase_static_family(torch, rt, api, cfg, params, trace, counters,
                        per_step, per_prefill, label):
    """(f) / (g): a static-only family at full width through run_static in
    groups of 8, every kernel counter zeroed just before and read just
    after. ``per_step`` / ``per_prefill``: {counter: launches expected a
    decode step / a prefill}. Then one greedy static decode is held
    against the full forward teacher-forced with its tokens."""
    print(f"== {label} static path, {cfg.name} full width", flush=True)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rep = rt.run_static(cfg, params, copy.deepcopy(trace), num_slots=8)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = {c.__name__: c.launches for c in counters}
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    print(f"  wall {wall:.3f} s  prefill wall {rep.prefill_wall_s:.3f} s  "
          f"decode wall {rep.decode_wall_s:.3f} s (+ first step "
          f"{rep.compile_wall_s:.3f} s)  decode tokens/s "
          f"{summary['tokens_per_s']}  cache bytes {rep.cache_bytes_alloc}",
          flush=True)
    for c in counters:
        want = (per_step.get(c, 0) * rep.decode_steps
                + per_prefill.get(c, 0) * rep.prefill_calls)
        print(f"  launches {c.__name__}: {c.launches} (expected {want})")
        assert c.launches == want, counts
    assert len(rep.completed) == len(trace)
    for r in rep.completed:
        assert len(r.generated) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab_size for t in r.generated)
    req = rep.completed[0]
    extra = {k: torch.as_tensor(v[None], device=DEV)
             for k, v in (req.extras or {}).items()}
    n, n_gen = len(req.prompt), 32
    fwd_kw = {}
    if cfg.moe:
        # the forward replays the prefill's expert drops on the prompt and
        # keeps every generated token, as dropless decode does
        _, keep = api.forward(cfg, params, {"tokens": torch.tensor(
            [list(req.prompt)], device=DEV)}, return_route_keep=True)
        keep = torch.cat([keep, torch.ones(
            (*keep.shape[:2], n_gen - 1, keep.shape[3]), dtype=torch.bool,
            device=DEV)], dim=2)
        fwd_kw = {"route_capacity": n + n_gen - 1, "route_keep": keep}
    gap, scale = static_consistency(torch, api, cfg, params,
                                    list(req.prompt), n_gen, extra, fwd_kw)
    print(f"  greedy static decode vs teacher-forced forward: gap {gap:.4e}"
          f" (logit scale {scale:.3e})", flush=True)
    # decode (decode kernel, M = 1 products) and forward (flash, M = S
    # products) round in bf16 at different places: a choice may trail the
    # argmax by a few bf16 quanta of the logit scale
    assert gap <= 16 * 2.0 ** -8 * max(scale, 1.0), gap
    return rep, counts


def phase_static_breakdown(torch, api, cfg, params):
    """(f') one olmoe static decode step (8 requests, 400 cached tokens of
    a 640-row cache) and one 512-token prefill, profiled."""
    print("== (f') where the time goes, olmoe-1b-7b static", flush=True)
    from repro_torch.models import moe as MoE
    B = 8
    state = MoE.init_decode_state(cfg, B, 640, device=DEV)
    state.pos = 400
    gen = torch.Generator(device=DEV).manual_seed(8)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=DEV,
                         dtype=torch.int32)
    breakdown(torch, f"decode step B={B}", lambda: api.decode_step(
        cfg, params, state, toks))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 512),
                                      generator=gen, device=DEV)}
    breakdown(torch, "prefill S=512", lambda: api.prefill(
        cfg, params, prompt, 512), steps=2)


# --- the vlm and ssm engine families (qwen2-vl-7b, rwkv6-7b) ------------------------


def phase_vlm_engine(torch, rt, ops, api, cfg, params, trace):
    """(h) qwen2-vl-7b through the paged engine, every request carrying
    its patch embeddings, with prefix sharing asked for (the vlm backend
    must refuse it: same token ids are not the same KV). Every kernel
    counter zeroed just before and read just after: one paged-decode
    launch a layer a decode step and one flash launch a layer a prefill,
    nothing else; the eager twin as in (b); the engine's tokens teacher-
    forced through the static path with the same patches. Returns the
    launch counts."""
    print("== (h) engine, qwen2-vl-7b full width and depth (patches)",
          flush=True)
    ecfg = engine_config(rt, prefix_sharing=True)
    engine = rt.Engine(cfg, params, ecfg)
    assert type(engine.backend).__name__ == "PagedTransformerBackend"
    assert not engine.backend.prefix_sharing
    counters = ops.launch_counters()
    for c in counters:
        c.launches = 0
    rep, rise = run_counted(torch, engine, trace)
    counts = {c.__name__: c.launches for c in counters}
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    print(f"  launches {counts}; per decode step and per prefill: "
          f"{cfg.num_layers} (decode steps {rep.decode_steps}, prefill calls "
          f"{rep.prefill_calls})", flush=True)
    want = {"paged_decode_attention": cfg.num_layers * rep.decode_steps,
            "flash_attention": cfg.num_layers * rep.prefill_calls}
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert rep.shared_page_hits == 0 and rep.cow_copies == 0
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    print_rates(rep, summary)
    eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    worst = max(static_gap(torch, api, cfg, params, r)
                for r in rep.completed[:3])
    req = rep.completed[0]
    lg = api.forward(cfg, params, {
        "tokens": torch.tensor([list(req.prompt)], device=DEV),
        "patch_embeds": torch.as_tensor(req.extras["patch_embeds"][None],
                                        device=DEV)})
    assert torch.isfinite(lg).all()
    scale = lg.abs().max().item()
    print(f"  teacher-forced greedy gap (static path, patches) {worst:.4e} "
          f"(logit scale {scale:.3e})", flush=True)
    # engine (paged kernel, batch of 8) and static path (dense decode
    # kernel, batch of 1) round in bf16 at different places: a choice may
    # trail the argmax by a few bf16 quanta of the logit scale
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    return counts


def phase_ssm_engine(torch, rt, ops, R, cfg, params, trace):
    """(i) rwkv6-7b through the recurrent backend (no pages; a constant
    state per slot): every request completes; no kernel of the eight
    launches (the WKV, token shift and group norm are torch ops); the
    report counts the state as slot_state_bytes in kv_bytes_peak; the
    eager twin as in (b); and the same requests served one at a time (each
    arriving after the previous one finished) give the same tokens."""
    print(f"== (i) engine, rwkv6-7b full width, {cfg.num_layers} layers "
          f"(recurrent)", flush=True)
    ecfg = engine_config(rt)
    engine = rt.Engine(cfg, params, ecfg)
    assert type(engine.backend).__name__ == "RecurrentBackend"
    counters = ops.launch_counters()
    for c in counters:
        c.launches = 0
    rep, rise = run_counted(torch, engine, trace)
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    assert not any(c.launches for c in counters), rise
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    L, B, D = cfg.num_layers, ecfg.num_slots, cfg.d_model
    state_bytes = 2 * (2 * L * B * D
                       + L * B * cfg.num_heads * cfg.head_dim ** 2) + 4
    assert rep.slot_state_bytes == rep.kv_bytes_peak == state_bytes, \
        (rep.slot_state_bytes, rep.kv_bytes_peak, state_bytes)
    assert rep.page_bytes == 0 and rep.peak_live_pages == 0
    print(f"  slot_state_bytes = kv_bytes_peak = {state_bytes} (bf16 shift "
          f"registers and WKV state of {B} slots, int32 position)",
          flush=True)
    print_rates(rep, summary)
    eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    solo, t = [], 0
    for r in sorted(trace, key=lambda r: r.arrival):
        solo.append(rt.Request(rid=r.rid, prompt=r.prompt.copy(),
                               max_new_tokens=r.max_new_tokens, arrival=t))
        t += r.max_new_tokens + 2
    srep = rt.Engine(cfg, params, ecfg).run(solo)
    done = sorted(srep.completed, key=lambda r: r.admitted_step)
    for a, b in zip(done, done[1:]):
        assert b.admitted_step >= a.done_step, "solo runs overlapped"
    want = {r.rid: r.generated for r in rep.completed}
    for r in srep.completed:
        assert r.generated == want[r.rid], f"request {r.rid} != its solo run"
    lg = R.forward(cfg, params, {"tokens": torch.tensor(
        [list(trace[0].prompt)], device=DEV)})
    assert torch.isfinite(lg).all()
    print(f"  each of the {len(solo)} requests served alone: the same "
          f"tokens; forward logits finite (scale "
          f"{lg.abs().max().item():.3e})", flush=True)


def phase_ssm_breakdown(torch, R, cfg, params):
    """(i') one rwkv6 decode step (8 slots, a random state) and one
    512-token prefill, profiled; the WKV's share of each one's device
    time: the WKV routine alone (the scan at S = 1, the chunked routine at
    S = 512), once a layer, on inputs of the step's shapes."""
    print("== (i') where the time goes, rwkv6-7b", flush=True)
    B, Lc, H, dh = 8, cfg.num_layers, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device=DEV).manual_seed(12)
    state = R.init_decode_state(cfg, B, device=DEV)
    for t in (state.att_prev, state.ffn_prev, state.wkv):
        t.normal_(generator=gen)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=DEV,
                         dtype=torch.int32)
    step_busy = breakdown(torch, f"decode step B={B}", lambda: R.decode_step(
        cfg, params, state, toks))
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 512),
                                      generator=gen, device=DEV)}
    prefill_busy = breakdown(torch, "prefill S=512", lambda: R.prefill(
        cfg, params, prompt), steps=2)

    def wkv_args(b, S):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=DEV)
        w = torch.exp(-torch.exp(rnd(b, S, H, dh)))
        return [t.to(torch.bfloat16) for t in (
            rnd(b, S, H, dh), rnd(b, S, H, dh), rnd(b, S, H, dh), w,
            0.5 * rnd(H, dh), torch.zeros((b, H, dh, dh), device=DEV))]

    dec_args, pre_args = wkv_args(B, 1), wkv_args(1, 512)
    wkv_dec = device_busy(torch, lambda: [R._wkv_scan(*dec_args)
                                          for _ in range(Lc)])
    wkv_pre = device_busy(torch, lambda: [R._wkv_chunked(*pre_args)
                                          for _ in range(Lc)])

    def share(part, whole):
        return f"{part / whole:.3f}" if part and whole else "not measured"

    print(f"  WKV device time: decode step {wkv_dec:.3f} of {step_busy:.3f}"
          f" ms (share {share(wkv_dec, step_busy)}); prefill S=512 "
          f"{wkv_pre:.3f} of {prefill_busy:.3f} ms (share "
          f"{share(wkv_pre, prefill_busy)})", flush=True)


# --- the hybrid family (recurrentgemma-9b) -------------------------------------------

# the depths of (i)-(i'') and (j)-(j''): rwkv6-7b and recurrentgemma-9b
# (4 periods and 2 rec layers) at full width cut in depth, so that the
# script keeps within its time with (o), which serves both at full depth;
# neither engine launches a kernel
SSM_LAYERS, HYBRID_LAYERS = 12, 14


def hybrid_trace(rt, cfg):
    """(b)'s 16 requests plus two that reach the window (2,048): request
    16, a 2,560-token prompt (longer than the window: admission maps only
    its 128 in-window pages) generating 64 tokens; request 17, a
    1,984-token prompt generating 160, whose ring wraps at positions
    2,064-2,128. Prompts from a seeded rng."""
    import numpy as np
    rng = np.random.default_rng(16)
    long = [rt.Request(rid=16, prompt=rng.integers(
                0, cfg.vocab_size, 2560).astype(np.int32),
                max_new_tokens=64, arrival=8),
            rt.Request(rid=17, prompt=rng.integers(
                0, cfg.vocab_size, 1984).astype(np.int32),
                max_new_tokens=160, arrival=16)]
    return engine_trace(rt, cfg) + long


def phase_hybrid_engine(torch, rt, ops, api, cfg, params, trace):
    """(j) recurrentgemma-9b through the hybrid backend (a recurrent
    state per slot, the attention window's KV in a ring of 129 pages a
    slot): every kernel counter zeroed just before and read just after
    (none of the eight launches: Griffin's attention is torch ops at head
    dim 256); every request completes untruncated; no slot holds more
    than 129 pages; pages are freed on ring wraps; the eager twin as in
    (b); each request's tokens teacher-forced through the static path at
    B = 1."""
    print(f"== (j) engine, recurrentgemma-9b full width, {cfg.num_layers} "
          f"layers (hybrid ring)", flush=True)
    from repro_torch.runtime import engine as eng
    R = -(-cfg.recurrent.window // 16) + 1
    ecfg = engine_config(rt, max_pages_per_seq=R, num_pages=1 + 8 * R)
    engine = rt.Engine(cfg, params, ecfg)
    assert type(engine.backend).__name__ == "HybridBackend"
    assert engine.backend.ring_rows == R
    wraps = {"frees": 0, "most": 0}
    growth_row = eng._growth_row

    def counted(backend, alloc, table, s, pi, rid):
        freed = int(table[s, pi % R]) != rt.TRASH_PAGE
        row = growth_row(backend, alloc, table, s, pi, rid)
        wraps["frees"] += freed
        wraps["most"] = max(wraps["most"], len(alloc.owned(rid)) + 1)
        return row

    counters = ops.launch_counters()
    for c in counters:
        c.launches = 0
    eng._growth_row = counted
    try:
        rep, rise = run_counted(torch, engine, trace)
    finally:
        eng._growth_row = growth_row
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    assert not any(c.launches for c in counters), rise
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    assert rep.peak_live_pages <= 8 * R, rep.peak_live_pages
    assert wraps["most"] <= R, wraps
    assert wraps["frees"] > 0, "no ring wrap freed a page"
    print(f"  ring: {R} rows a slot, at most {wraps['most']} pages held by "
          f"a request, {wraps['frees']} pages freed on wraps, peak live "
          f"pages {rep.peak_live_pages} of {8 * R}; page bytes "
          f"{rep.page_bytes}, slot state bytes {rep.slot_state_bytes}",
          flush=True)
    print_rates(rep, summary)
    eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    # the first three requests and the two that reach the window (16, 17:
    # past 2,048 tokens the forward takes the chunked windowed attention)
    done = {r.rid: r for r in rep.completed}
    checked = [done[i] for i in (0, 1, 2, 16, 17)]
    worst = max(greedy_gap(torch, api, cfg, params, r) for r in checked)
    lg = api.forward(cfg, params, {"tokens": torch.tensor(
        [list(trace[0].prompt)], device=DEV)})
    assert torch.isfinite(lg).all()
    scale = lg.abs().max().item()
    print(f"  teacher-forced greedy gap (full forward, requests "
          f"{[r.rid for r in checked]}) {worst:.4e} (logit scale "
          f"{scale:.3e})", flush=True)
    # engine (paged ring, batch of 8) and forward (the whole sequence at
    # once) round in bf16 at different places: a choice may trail the
    # argmax by a few bf16 quanta of the logit scale
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    return rep


def print_hybrid_bound(torch, cfg, params, rep, step_ms: float) -> None:
    """(j)'s rates beside the graphed decode step's device time (from
    (j'')'s horizon: 8 slots at 400 tokens) and its bound: the bytes one
    step must move over the card's memory rate. Every weight is read once
    (of the embedding table only the 8 rows looked up), the recurrent
    state read and written, the ring's 400 live keys and values a slot
    read, the f32 logits written; the step's operations are far below
    the bf16 peak at 8 rows."""
    from repro_torch.models import griffin as G

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    B, n_tok = 8, 400
    emb = params["embed"]
    weights = nbytes(params) - nbytes(emb) + B * emb[0].numel() \
        * emb.element_size()
    n_rec, n_attn = G._state_counts(cfg)
    W = cfg.recurrent.lru_width or cfg.d_model
    state = 2 * n_rec * B * W * ((cfg.recurrent.conv_width - 1) * 2 + 4)
    kv = n_attn * B * n_tok * 2 * cfg.num_kv_heads * cfg.head_dim * 2
    logits = B * cfg.vocab_size * 4
    total = weights + state + kv + logits
    bound_ms = total / PEAK_BYTES_PER_S * 1e3
    print(f"  (j) tokens/s {rep.summary()['tokens_per_s']} (engine, "
          f"graphed); graphed decode step {step_ms:.3f} ms device busy; "
          f"bound {bound_ms:.3f} ms ({total / 2**30:.2f} GiB a step: "
          f"weights {weights / 2**30:.2f} GiB, state and ring KV "
          f"{(state + kv) / 2**20:.1f} MiB) at {PEAK_BYTES_PER_S / 1e12} "
          f"TB/s; step / bound "
          + (f"{step_ms / bound_ms:.2f}" if step_ms else "not measured"),
          flush=True)


def phase_hybrid_breakdown(torch, G, cfg, params):
    """(j') one recurrentgemma decode step (8 slots x 400 tokens in a
    129-row ring, a random state) and one 512-token prefill, profiled:
    host enqueue against device busy; the RG-LRU scan's share of each
    one's device time: the scan alone, once a rec layer, on inputs of the
    call's shapes."""
    print("== (j') where the time goes, recurrentgemma-9b", flush=True)
    B, page = 8, 16
    R = G.ring_rows(cfg.recurrent.window, page)
    gen = torch.Generator(device=DEV).manual_seed(13)
    state = G.init_paged_decode_state(cfg, B, 1 + B * R, page, device=DEV)
    for t in (state.conv, state.h, state.k_pages, state.v_pages):
        t.normal_(generator=gen)
    table = torch.arange(1, 1 + B * R, dtype=torch.int32,
                         device=DEV).view(B, R)
    lens = torch.full((B,), 400, dtype=torch.int32, device=DEV)
    toks = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device=DEV,
                         dtype=torch.int32)
    act = torch.ones((B,), dtype=torch.bool, device=DEV)
    busy = {"decode step": breakdown(
        torch, f"decode step B={B}", lambda: G.paged_decode_step(
            cfg, params, state, toks, table, lens, act))}
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 512),
                                      generator=gen, device=DEV)}
    plen = torch.tensor([512], dtype=torch.int32, device=DEV)
    busy["prefill S=512"] = breakdown(
        torch, "prefill S=512", lambda: G.paged_prefill(
            cfg, params, prompt, plen), steps=1)
    n_rec, _ = G._state_counts(cfg)
    W = cfg.recurrent.lru_width or cfg.d_model
    lam = params["super"]["rec1"]["lam"][0]
    parts = []
    for label, b, S in (("decode step", B, 1), ("prefill S=512", 1, 512)):
        x, r, i = (torch.randn((b, S, W), generator=gen, device=DEV).to(
            torch.bfloat16) for _ in range(3))
        h0 = torch.zeros((b, W), device=DEV)
        scan = device_busy(torch, lambda: [G._rglru(x, r, i, lam, h0)
                                           for _ in range(n_rec)])
        whole = busy[label]
        parts.append(f"{label} {scan:.3f} of {whole:.3f} ms (share "
                     + (f"{scan / whole:.3f})" if scan and whole
                        else "not measured)"))
    print("  RG-LRU scan device time: " + "; ".join(parts), flush=True)


def static_mode_lines(out: list[str], args) -> None:
    """The static mode's printed lines, as the reference prints them for
    the flags ``args``: the header, prefill ms and decode ms a token, up
    to two seq rows of ``--gen`` tokens, ``ok``."""
    for line in out:
        print(f"  {line}")
    assert out[-1] == "ok", out
    assert out[0].endswith(
        f"mode=static batch={args.batch} prompt={args.prompt_len} "
        f"gen={args.gen}"), out[0]
    assert out[1].startswith("prefill: ") and out[1].endswith("ms/token")
    rows = out[2:-1]
    assert len(rows) == min(args.batch, 2), rows
    for b, row in enumerate(rows):
        assert row.startswith(f"  seq{b}: ["), row
        assert len(row.split(",")) == args.gen, row


def run_captured(torch, fn, rc_want: int = 0) -> list[str]:
    """``fn()`` with its standard output captured: its lines (it must
    return ``rc_want``)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    torch.cuda.synchronize()
    assert rc == rc_want, rc
    return buf.getvalue().rstrip().splitlines()


def phase_host_pair(torch, rt, T, cfg, params, h=8, reps=5):
    """(c+), with ``--parent``: the host's share of the one-rank model code
    of this tree and the parent's, in turns (parent, this, this, parent)
    within this call, on the same params, state and inputs: an eager
    fused horizon of ``h`` engine steps from (b'')'s state (8 slots x 400
    cached tokens, 40-page table rows) and a static decode step (8 rows
    at position 400 of a 640-token cache). Prints each turn's median host
    enqueue and wall a step, and this tree's over the parent's; the two
    trees' tokens and logits must be equal bit for bit."""
    import importlib
    import statistics
    print(f"== (c+) host enqueue, parent tree vs this tree, {cfg.name}",
          flush=True)
    trees = {"parent": (
        importlib.import_module("parent_repro_torch.runtime"),
        importlib.import_module("parent_repro_torch.models.transformer")),
        "this": (rt, T)}
    B, M, page, ctx = 8, 40, 16, 400
    ecfg = rt.EngineConfig(num_slots=B, page_size=page, num_pages=1 + B * M,
                           max_pages_per_seq=M, prefill_bucket=128,
                           greedy=True, horizon=h)
    gen = torch.Generator(device=DEV).manual_seed(9)
    start = dict(
        pending=torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                              device=DEV, dtype=torch.int32),
        lengths=torch.full((B,), ctx, dtype=torch.int32, device=DEV),
        remaining=torch.full((B,), h, dtype=torch.int32, device=DEV))
    table = torch.arange(1, 1 + B * M, dtype=torch.int32,
                         device=DEV).view(B, M)
    mask = torch.ones((B,), dtype=torch.bool, device=DEV)
    cache = T.init_decode_state(cfg, B, 640)
    cache.k.normal_(generator=gen)
    cache.v.normal_(generator=gen)
    tokens = start["pending"].clone()
    backends = {}
    for name, (trt, _) in trees.items():
        be = trt.resolve_backend(cfg)(cfg, params, ecfg)
        g = torch.Generator(device=DEV).manual_seed(10)
        for t in vars(be.state).values():
            if isinstance(t, torch.Tensor):
                t.normal_(generator=g)
        backends[name] = be

    def horizon(name):
        t = {k: v.clone() for k, v in start.items()}
        return backends[name].decode_eager(
            t["pending"], t["lengths"], t["remaining"], table, mask, h)

    def static(name):
        tm = trees[name][1]
        state = tm.DecodeState(k=cache.k, v=cache.v, pos=ctx)
        return tm.decode_step(cfg, params, state, tokens)[0]

    def turn(fn, name, per_call):
        enq, wall = [], []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(name)
            enq.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t0)
        return (statistics.median(enq) * 1e3 / per_call,
                statistics.median(wall) * 1e3 / per_call, out)

    with torch.no_grad():
        for label, fn, per_call in (("eager horizon", horizon, h),
                                    ("static decode step", static, 1)):
            outs = {name: fn(name) for name in trees}      # warm-up
            same = (torch.equal(outs["parent"], outs["this"])
                    if label == "static decode step" else
                    all(torch.equal(a, b) for a, b in zip(
                        outs["parent"], outs["this"])))
            assert same, f"{label}: the trees' results differ"
            got = {"parent": [], "this": []}
            for name in ("parent", "this", "this", "parent"):
                enq, wall, _ = turn(fn, name, per_call)
                got[name].append((enq, wall))
                print(f"  {label}, {name}: host enqueue {enq:.3f} ms  wall "
                      f"{wall:.3f} ms a step", flush=True)
            mean = {n: [sum(v[i] for v in got[n]) / 2 for i in (0, 1)]
                    for n in got}
            print(f"  {label}: this / parent host enqueue "
                  f"{mean['this'][0] / mean['parent'][0]:.4f}, wall "
                  f"{mean['this'][1] / mean['parent'][1]:.4f}; results "
                  f"equal bit for bit", flush=True)
    del backends, cache
    torch.cuda.empty_cache()


def phase_static_mode(torch, serve, L, ref, cfg, params, argv, counters):
    """(j+, dense) the entry point's lockstep static mode
    (``serve.run_static_mode``, the reference's ``run_static``) on
    codeqwen1.5-7b at full width, on the params (b) and (c) hold: every
    kernel counter zeroed just before and read just after (one dense
    decode launch a layer a decode step, one flash launch a layer for the
    one prefill, nothing else), and no plain attention or expert GEMM
    called."""
    print(f"== (j+) static mode, {cfg.name} ((b)'s params): "
          f"{' '.join(argv)}", flush=True)
    args = serve.parse_args(argv)
    plain = {"ref.mha_attention": (ref, "mha_attention"),
             "ref.decode_attention": (ref, "decode_attention"),
             "ref.paged_decode_attention": (ref, "paged_decode_attention"),
             "ref.grouped_mvm": (ref, "grouped_mvm"),
             "layers.gqa_attention": (L, "gqa_attention")}
    calls = dict.fromkeys(plain, 0)
    saved = {k: getattr(m, n) for k, (m, n) in plain.items()}

    def counted(key):
        def call(*a, **kw):
            calls[key] += 1
            return saved[key](*a, **kw)
        return call

    for k, (m, n) in plain.items():
        setattr(m, n, counted(k))
    for c in counters:
        c.launches = 0
    try:
        out = run_captured(torch, lambda: serve.run_static_mode(
            cfg, params, args))
    finally:
        for k, (m, n) in plain.items():
            setattr(m, n, saved[k])
    static_mode_lines(out, args)
    counts = {c.__name__: c.launches for c in counters}
    want = {"decode_attention": cfg.num_layers * args.gen,
            "flash_attention": cfg.num_layers}
    print(f"  launches {counts}; plain versions called {calls}", flush=True)
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert not any(calls.values()), calls
    return counts


def phase_static_entry(torch, serve, argv):
    """(j+, hybrid) the static serving entry point at full width:
    ``launch.serve.main(argv)`` (random weights from its seed) must
    return 0 and print the reference's lines; no kernel of the eight
    launches (Griffin's attention is torch ops)."""
    from repro_torch.kernels import ops
    print(f"== (j+) launch.serve {' '.join(argv)}", flush=True)
    counters = ops.launch_counters()
    for c in counters:
        c.launches = 0
    t0 = time.monotonic()
    out = run_captured(torch, lambda: serve.main(argv))
    static_mode_lines(out, serve.parse_args(argv))
    assert not any(c.launches for c in counters), \
        {c.__name__: c.launches for c in counters}
    print(f"  no kernel launches; entry point wall "
          f"{time.monotonic() - t0:.1f} s (init included)", flush=True)


# --- the multi-tenant pool and the fleet (codeqwen, deepseek, rwkv6) -------------

POOL_ZOO = "codeqwen1.5-7b:2,deepseek-v2-lite-16b:1,rwkv6-7b:1"
# the fleet's chaos: r0's reload link at a quarter for 100 ticks, r1 killed
FLEET_CHAOS = "kill@10:r1,dma@2:r0x4/100"


def pool_engine_config(rt, **kw):
    """(k)/(k')'s engine settings: (b)'s (8 slots, page 16, 40-page rows,
    prefill bucket 128, greedy, horizons of 32) over the pool; ``kw``
    sets the policy and stream."""
    return rt.PoolEngineConfig(**{**dict(
        num_slots=8, page_size=16, num_pages=1 + 8 * 40,
        max_pages_per_seq=40, prefill_bucket=128, greedy=True, horizon=32),
        **kw})


def pool_trace(rt, tenants, kind, mean_interarrival):
    """A seeded zoo trace (``kind``: multi_tenant_trace or diurnal_trace) of
    24 requests by share, prompts 128-512, generations 32-128."""
    return getattr(rt, kind)(tenants, 24,
                             mean_interarrival=mean_interarrival,
                             prompt_lens=(128, 256, 384, 512),
                             gen_lens=(32, 64, 96, 128), seed=0)


class TenantLaunches:
    """Each tenant's kernel launches in a pooled run: every backend's
    ``prefill`` and ``decode_fused`` are wrapped to charge the rise of
    each launch counter to the tenant, and to count its decode steps (the
    horizons' h) and prefills."""

    def __init__(self, backends: dict, counters):
        self.counters = counters
        self.counts = {m: dict.fromkeys((c.__name__ for c in counters), 0)
                       for m in backends}
        self.steps = dict.fromkeys(backends, 0)
        self.prefills = dict.fromkeys(backends, 0)
        for m, be in backends.items():
            be.prefill = self._wrap(m, be.prefill, "prefill")
            be.decode_fused = self._wrap(m, be.decode_fused, "decode")

    def _wrap(self, m, fn, kind):
        def call(*a, **kw):
            before = [c.launches for c in self.counters]
            out = fn(*a, **kw)
            for c, b in zip(self.counters, before):
                self.counts[m][c.__name__] += c.launches - b
            if kind == "prefill":
                self.prefills[m] += 1
            else:
                self.steps[m] += a[5]
            return out
        return call


def graph_replays(graph) -> int:
    """A tenant's decode graph (each tenant captures its own): the card
    decodes graphed. Returns its replays."""
    assert graph is not None and graph.graphed, "the card decodes graphed"
    return graph.replays


def eager_fused(torch, be):
    """``be``'s fused horizon on the eager loop (every kernel enqueued from
    the host) in place of its graph replays."""
    def run(pending, lengths, remaining, table, mask, h, teacher=None):
        return be.decode_eager(pending, lengths, remaining, table,
                               torch.as_tensor(mask, device=DEV), h, teacher)
    return run


def plain_calls(ref, L):
    """Wrap every plain version of a kernel of the eight, of the flash
    and grouped GEMM backwards (and the plain GQA attention) to count its
    calls; returns (calls, restore)."""
    plain = {"ref.mha_attention": (ref, "mha_attention"),
             "ref.decode_attention": (ref, "decode_attention"),
             "ref.paged_decode_attention": (ref, "paged_decode_attention"),
             "ref.grouped_mvm": (ref, "grouped_mvm"),
             "layers.gqa_attention": (L, "gqa_attention"),
             **{f"ref.{n}": (ref, n) for n in (
                 "flash_attention_bwd", "flash_bwd_rowdot", "flash_bwd_dkdv",
                 "flash_bwd_dq", "grouped_mvm_bwd_dx", "grouped_mvm_bwd_dw")}}
    calls = dict.fromkeys(plain, 0)
    saved = {k: getattr(m, n) for k, (m, n) in plain.items()}

    def counted(key):
        def call(*a, **kw):
            calls[key] += 1
            return saved[key](*a, **kw)
        return call

    for k, (m, n) in plain.items():
        setattr(m, n, counted(k))

    def restore():
        for k, (m, n) in plain.items():
            setattr(m, n, saved[k])
    return calls, restore


def pool_run(torch, rt, ops, pcfg, zoo, cfgs, params, trace, eager=False,
             **ekw):
    """One PooledEngine run of ``trace`` on a fresh pool: (report, pool,
    engine, tenant launches, host seconds). Every request completes at
    its budget with tokens in its tenant's vocabulary."""
    pool = rt.ModelPool(pcfg)
    for arch, share in zoo:
        pool.register(arch, cfgs[arch], demand=share)
    pool.pack()
    eng = rt.PooledEngine(pool, params, pool_engine_config(rt, **ekw))
    if eager:
        for be in eng.backends.values():
            be.decode_fused = eager_fused(torch, be)
    tl = TenantLaunches(eng.backends, ops.launch_counters())
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rep = eng.run(copy.deepcopy(trace))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert len(rep.completed) == len(trace)
    for r in rep.completed:
        assert not r.truncated and len(r.generated) == r.max_new_tokens
        assert all(0 <= t < cfgs[r.model_id].vocab_size
                   for t in r.generated)
    return rep, pool, eng, tl, wall


def pool_line(label, rep, wall) -> None:
    s = rep.summary()
    print(f"  {label}: tokens/step {s['tokens_per_step']}  stall steps "
          f"{s['stall_steps']} {s['stall_steps_by_model']}  reload "
          f"{rep.reload_bytes / 1e9:.2f} GB ({s['reload_events']} events)  "
          f"evictions {s['evictions']}  deferred "
          f"{s['deferred_activations']}  preemptions {s['preemptions']}  "
          f"decode steps {s['decode_steps']}  dispatches "
          f"{s['device_dispatches']}  host syncs {s['host_syncs']}  decode "
          f"wall {rep.decode_wall_s:.3f} s  tokens/s {s['tokens_per_s']}  "
          f"run {wall:.1f} s", flush=True)


POOL_LEDGER = ("decode_steps", "slot_steps", "useful_slot_steps",
               "prefill_calls", "prefill_tokens", "preemptions",
               "peak_live_pages", "peak_live_page_bytes", "device_dispatches",
               "host_syncs", "page_table_upload_bytes", "new_tokens",
               "stall_steps", "stall_steps_by_model", "reload_bytes",
               "restream_bytes", "reload_events", "evictions",
               "deferred_activations", "model_tokens")


def tokens(rep) -> dict:
    return {r.rid: r.generated for r in rep.completed}


def same_requests(a, b) -> int:
    """Requests whose token streams are identical in two runs."""
    tb = tokens(b)
    return sum(t == tb[rid] for rid, t in tokens(a).items())


def free_card(torch) -> None:
    """Drop what the last runs left (graphs and pools form cycles)."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def host_link_rate(torch, nbytes: int) -> float:
    """The pinned host-to-device copy rate alone: ``nbytes`` from pinned
    memory into the card, 5 copies timed with CUDA events, bytes/s."""
    src = torch.empty((nbytes,), dtype=torch.uint8, pin_memory=True)
    dst = torch.empty((nbytes,), dtype=torch.uint8, device=DEV)
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(5):
        dst.copy_(src, non_blocking=True)
    end.record()
    end.synchronize()
    rate = 5 * nbytes / (start.elapsed_time(end) / 1e3)
    del src, dst
    return rate


def phase_pool(torch, rt, ops, ref, L, T, serve, kernels):
    """(k) the multi-tenant pool at full width and depth: codeqwen1.5-7b
    (share 2), deepseek-v2-lite-16b and rwkv6-7b (61.85 GB of bf16
    weights across the paged, latent-page and recurrent backends) under
    the reference's auto budget and the H100 reload clock. Four runs of
    one seeded 24-request trace: reload-aware and round-robin at model
    granularity, reload-aware with layer streaming through the device DMA
    channel (the main path: every launch counter zeroed just before and
    read just after, per tenant), and that run's eager twin. Asserts the
    pool's claims (the same tokens; reload-aware ahead on tokens/step
    with fewer reload bytes; layer streaming with fewer stall steps),
    measured DMA stalls within the modeled ones, the launches each tenant
    owes, no plain version called, and the first three codeqwen requests
    as greedy choices of the full forward. Returns (params, cfgs, zoo,
    pcfg) for (k')."""
    print("== (k) pool, codeqwen1.5-7b:2 + deepseek-v2-lite-16b + rwkv6-7b "
          "full width and depth", flush=True)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    print(f"  card memory allocated before the pool: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    args = serve.parse_args(["--mode", "pool", "--full", "--zoo", POOL_ZOO,
                             "--device", "cuda"])
    zoo, cfgs, tenants = serve.zoo_configs(args)
    from repro_torch.models import get_model
    params = {arch: init(torch, get_model(cfg), cfg)
              for arch, cfg in cfgs.items()}
    need = sum(rt.model_weight_bytes(c) for c in cfgs.values())
    print(f"  zoo weights (model_weight_bytes) {need / 1e9:.2f} GB; params "
          f"on the card {torch.cuda.memory_allocated() / 1e9:.2f} GB",
          flush=True)
    pcfg = serve.pool_config(cfgs, args)
    trace = pool_trace(rt, tenants, "multi_tenant_trace", 4.0)
    counters = ops.launch_counters()
    names = [c.__name__ for c in counters]

    reps = {}
    for label, ekw in (("reload_aware/model", dict(stream="model")),
                       ("round_robin/model", dict(policy="round_robin",
                                                  stream="model"))):
        rep, _, _, _, wall = pool_run(torch, rt, ops, pcfg, zoo, cfgs,
                                      params, trace, **ekw)
        reps[label] = rep
        pool_line(label, rep, wall)
        free_card(torch)

    # the main path: every counter zeroed just before, read just after
    dpcfg = dataclasses.replace(pcfg, device_dma=True, dma_device=DEV)
    calls, restore = plain_calls(ref, L)
    for c in counters:
        c.launches = 0
    try:
        rep, pool, eng, tl, wall = pool_run(torch, rt, ops, dpcfg, zoo, cfgs,
                                            params, trace, stream="layer")
    finally:
        restore()
    launches = {n: c.launches for n, c in zip(names, counters)}
    reps["reload_aware/layer"] = rep
    pool_line("reload_aware/layer (device DMA)", rep, wall)
    print(f"  plan: {json.dumps(pool.plan.summary()['models'])}",
          flush=True)
    for m in eng.backends:
        print(f"  {m}: decode steps {tl.steps[m]}, prefills "
              f"{tl.prefills[m]}, launches "
              f"{ {k: v for k, v in tl.counts[m].items() if v} }, "
              f"{graph_replays(eng.backends[m].graph)} graph replays",
              flush=True)
    print(f"  launches on the pool path {launches}; plain versions called "
          f"{calls}", flush=True)
    assert not any(calls.values()), calls
    cq, ds, rw = "codeqwen1.5-7b", "deepseek-v2-lite-16b", "rwkv6-7b"
    Lq, Ld = cfgs[cq].num_layers, 3 * cfgs[ds].num_layers
    assert tl.counts[cq]["paged_decode_attention"] == Lq * tl.steps[cq]
    assert tl.counts[cq]["flash_attention"] == Lq * tl.prefills[cq]
    assert tl.counts[ds]["grouped_mvm"] == Ld * (tl.steps[ds]
                                                 + tl.prefills[ds])
    assert not any(tl.counts[rw].values()), tl.counts[rw]
    assert all(tl.counts[cq][n] == 0 for n in names
               if n not in ("paged_decode_attention", "flash_attention"))
    for k in kernels:
        if k["name"] in ("paged_decode_attention", "flash_attention",
                         "grouped_mvm"):
            k["launches_pool"] = launches[k["name"]]
            assert k["launches_pool"] > 0, k["name"]
    assert sum(launches.values()) == sum(sum(v.values())
                                         for v in tl.counts.values())

    dma = pool.dma
    dma.check()
    print(f"  device DMA: {dma.copies_issued} copies, "
          f"{dma.copied_bytes / 1e9:.2f} GB host to card on its own stream "
          f"beside the decode; measured stalls {dma.measured_stall_steps} "
          f"({dma.measured_wait_s:.4f} s) against {rep.stall_steps} "
          f"modeled", flush=True)
    assert dma.copies_issued > 0
    assert dma.measured_stall_steps <= rep.stall_steps, \
        (dma.measured_stall_steps, rep.stall_steps)
    alone = host_link_rate(torch, pcfg.reload_bytes_per_step)
    print(f"  pinned host-to-device rate alone: {alone / 1e9:.2f} GB/s "
          f"({pcfg.reload_bytes_per_step / 1e6:.1f} MB copies); the "
          f"clock's constant HOST_LINK_BYTES_PER_S "
          f"{rt.HOST_LINK_BYTES_PER_S / 1e9:.2f} GB/s", flush=True)
    done = sorted((r for r in rep.completed if r.model_id == cq),
                  key=lambda r: r.rid)[:3]
    worst = max(greedy_gap(torch, T, cfgs[cq], params[cq], r) for r in done)
    lg = T.forward(cfgs[cq], params[cq], {"tokens": torch.tensor(
        [list(done[0].prompt)], device=DEV)})
    assert torch.isfinite(lg).all()
    scale = lg.abs().max().item()
    print(f"  teacher-forced greedy gap (full forward, codeqwen requests "
          f"{[r.rid for r in done]}) {worst:.4e} (logit scale "
          f"{scale:.3e})", flush=True)
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    del pool, eng
    free_card(torch)

    erep, _, eeng, etl, ewall = pool_run(torch, rt, ops, dpcfg, zoo, cfgs,
                                         params, trace, eager=True,
                                         stream="layer")
    assert all(b.graph is None for b in eeng.backends.values())
    assert tokens(erep) == tokens(rep), "eager twin: tokens differ"
    for f in POOL_LEDGER:
        assert getattr(erep, f) == getattr(rep, f), f
    assert etl.counts == tl.counts, (etl.counts, tl.counts)
    print(f"  eager twin: same tokens, ledger and launches; decode wall "
          f"{erep.decode_wall_s:.3f} s against {rep.decode_wall_s:.3f} s "
          f"graphed, tokens/s {erep.summary()['tokens_per_s']} against "
          f"{rep.summary()['tokens_per_s']} (run {ewall:.1f} s)",
          flush=True)
    del eeng
    free_card(torch)

    ra, rr = reps["reload_aware/model"], reps["round_robin/model"]
    lay = reps["reload_aware/layer"]
    # bench_serve's check(): the policies generate the same tokens (its
    # count; preemption and re-prefill may move a bf16 near-tie)
    assert ra.new_tokens == rr.new_tokens == lay.new_tokens
    ratio = ra.tokens_per_step / rr.tokens_per_step
    print(f"  claims: reload-aware / round-robin tokens/step {ratio:.3f}, "
          f"reload bytes {ra.reload_bytes / 1e9:.2f} against "
          f"{rr.reload_bytes / 1e9:.2f} GB; stall steps layer "
          f"{lay.stall_steps} against model {ra.stall_steps}; requests "
          f"with identical tokens: round-robin {same_requests(ra, rr)}, "
          f"layer {same_requests(ra, lay)} of {len(trace)}", flush=True)
    assert ratio > 1.0, ratio
    assert ra.reload_bytes < rr.reload_bytes
    assert lay.stall_steps < ra.stall_steps
    print(f"  peak card memory in (k): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return params, cfgs, zoo, tenants, pcfg


def split_logits(torch, api, cfg, params, req, j: int):
    """The clean logits (V,) before ``req``'s generated token ``j``, fed
    the prompt and ``req.generated[:j]``: the full forward for the dense
    family, else the static path at B = 1 (prefill, then one decode step
    a token), which routes (deepseek) and recurs (rwkv6) as the engine
    does."""
    prompt = torch.tensor([list(req.prompt)], device=DEV)
    if cfg.family == "dense":
        seq = torch.tensor([list(req.prompt) + list(req.generated[:j])],
                           device=DEV)
        return api.forward(cfg, params, {"tokens": seq})[0, -1]
    logits, state = api.prefill(cfg, params, {"tokens": prompt},
                                len(req.prompt) + j + 1)
    for t in req.generated[:j]:
        logits, state = api.decode_step(cfg, params, state,
                                        torch.tensor([t], device=DEV))
    return logits[0]


def consistent_tokens(torch, cfgs, params, reps) -> None:
    """The same tokens per request across ``reps``: the same count, and
    where a request's streams differ (a preemption's re-prefill, or
    another GEMM routine for another batch or replica, can move a bf16
    near-tie) they split at a near-tie: at the first position where they
    differ, every stream's token is within (b)'s bound of the clean
    logits' maximum there (``split_logits``). Past the split each
    stream continues its own context."""
    from repro_torch.models import get_model
    base = {r.rid: r for r in reps[0].completed}
    split = {}
    for rep in reps[1:]:
        for r in rep.completed:
            b = base[r.rid].generated
            assert len(r.generated) == len(b), r.rid
            if r.generated != b:
                j = next(i for i, (x, y) in enumerate(zip(r.generated, b))
                         if x != y)
                split[r.rid] = min(j, split.get(r.rid, j))
    worst, where = 0.0, []
    for rid, j in sorted(split.items()):
        m = base[rid].model_id
        cfg, api = cfgs[m], get_model(cfgs[m])
        row = split_logits(torch, api, cfg, params[m], base[rid], j)
        bound = 16 * 2.0 ** -8 * max(row.abs().max().item(), 1.0)
        for rep in reps:
            t = next(r for r in rep.completed if r.rid == rid).generated[j]
            gap = (row.max() - row[t]).item()
            assert gap <= bound, (rid, m, j, t, gap, bound)
            worst = max(worst, gap / bound)
        where.append(f"{rid} ({m.split('-')[0]}) at {j}")
    print(f"  tokens: every request the same count in {len(reps)} runs; "
          f"{len(base) - len(split)} of {len(base)} identical, the other "
          f"{len(split)} split at a near-tie ({', '.join(where) or '-'}; "
          f"worst gap {worst:.3f} of its bound)", flush=True)


def fleet_run(torch, rt, zoo, cfgs, params, pcfg, trace, fcfg, spec=""):
    fleet = rt.FleetEngine([(a, cfgs[a], s) for a, s in zoo], pcfg,
                           pool_engine_config(rt, stream="layer"), params,
                           fcfg, faults=rt.FaultSchedule.parse(spec)
                           if spec else None)
    for r in fleet.replicas:
        for m in r.models:      # the replicas share one params dict
            assert r.engine.backends[m].params is params[m]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    rep = fleet.run(copy.deepcopy(trace))
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    assert rep.requests_lost == 0
    print(f"  {fcfg.placement} (min copies {fcfg.min_copies}) "
          f"{spec or 'clean'}: placement {rep.placement}; tokens/step "
          f"{rep.tokens_per_step:.3f}  reload {rep.reload_bytes / 1e9:.2f} "
          f"GB  ticks {rep.ticks}  failovers {rep.failovers}  "
          f"re-admissions {rep.re_admissions}  shed {rep.requests_shed}  "
          f"queue age p50/p99 {rep.queue_age_percentile(50):.1f}/"
          f"{rep.queue_age_percentile(99):.1f}  run {wall:.1f} s; replicas "
          + "; ".join(f"{x['replica']} {x['models']} decode "
                      f"{x['decode_steps']} stall {x['stall_steps']} "
                      f"done {x['completed']}" for x in rep.per_replica),
          flush=True)
    print(f"  card memory allocated {torch.cuda.memory_allocated() / 2**30:.2f}"
          f" GiB, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del fleet
    free_card(torch)
    return rep


def phase_fleet(torch, rt, serve, params, cfgs, zoo, tenants, pcfg):
    """(k') two replicated pools on one card over (k)'s params (held once:
    only the KV pools and graphs multiply), on a seeded 24-request
    diurnal trace, routers capping a replica's queue at 8 (its slots):
    demand placement at one copy a model against mirror (the same tokens
    per request, ahead on tokens/step with fewer reload bytes), then the
    chaos run ``FLEET_CHAOS`` at the reference's two copies a model (on
    this zoo every model on both replicas, as mirror): no request lost, a
    failover and re-admissions, p99 queue age within 10x the clean run's.
    Then the entry points ``serve.run_pool`` and ``serve.run_fleet`` on
    the same params."""
    print("== (k') fleet of 2 replicas on (k)'s params", flush=True)
    trace = pool_trace(rt, tenants, "diurnal_trace", 0.5)
    demand = fleet_run(torch, rt, zoo, cfgs, params, pcfg, trace,
                       rt.FleetConfig(n_replicas=2, placement="demand",
                                      min_copies=1,
                                      max_queue_per_replica=8))
    mirror = fleet_run(torch, rt, zoo, cfgs, params, pcfg, trace,
                       rt.FleetConfig(n_replicas=2, placement="mirror",
                                      max_queue_per_replica=8))
    chaos = fleet_run(torch, rt, zoo, cfgs, params, pcfg, trace,
                      rt.FleetConfig(n_replicas=2, placement="demand",
                                     max_queue_per_replica=8), FLEET_CHAOS)
    assert demand.placement != mirror.placement
    assert chaos.placement == mirror.placement
    consistent_tokens(torch, cfgs, params, [demand, mirror, chaos])
    ratio = demand.tokens_per_step / mirror.tokens_per_step
    factor = chaos.queue_age_percentile(99) / max(
        mirror.queue_age_percentile(99), 1.0)
    print(f"  claims: demand / mirror tokens/step {ratio:.3f}, reload "
          f"{demand.reload_bytes / 1e9:.2f} against "
          f"{mirror.reload_bytes / 1e9:.2f} GB; chaos lost "
          f"{chaos.requests_lost}, shed {chaos.requests_shed}, failovers "
          f"{chaos.failovers}, re-admissions {chaos.re_admissions} (latency "
          f"max {max(chaos.re_admission_latency, default=0)} ticks), p99 "
          f"queue age factor {factor:.3f}", flush=True)
    assert ratio > 1.0, ratio
    assert demand.reload_bytes < mirror.reload_bytes
    assert chaos.requests_lost == 0 and chaos.failovers >= 1
    assert chaos.re_admissions >= 1 and factor <= 10.0
    pool_entry_points(torch, serve, params)
    print(f"  peak card memory in (k) and (k'): "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def pool_entry_points(torch, serve, params) -> None:
    """``launch.serve``'s pool and fleet modes (``run_pool``,
    ``run_fleet``) at full width on ``params``: 8 slots, 12 requests of
    prompts 128-256 and generations 16-64, greedy; each must print its
    header and ``ok``."""
    for mode, extra in (("pool", []), ("fleet", ["--chaos", FLEET_CHAOS])):
        argv = ["--mode", mode, "--full", "--zoo", POOL_ZOO, "--batch", "8",
                "--prompt-len", "256", "--gen", "64", "--requests", "12",
                "--mean-interarrival", "2", "--greedy", *extra]
        args = serve.parse_args(argv)
        fn = serve.run_pool if mode == "pool" else serve.run_fleet
        t0 = time.monotonic()
        out = run_captured(torch, lambda: fn(args, params))
        assert out[-1] == "ok", out[-1]
        head = [ln for ln in out if ln.startswith(f"zoo={POOL_ZOO} mode=")]
        assert len(head) == 1, out[:3]
        print(f"  serve {' '.join(argv)}: {out[0]}; {head[0]}; ok "
              f"({time.monotonic() - t0:.1f} s)", flush=True)
        free_card(torch)


# --- training: the flash backward and launch.train ---------------------------------

# (label, B, H, KV, S, T, dh, causal) of the flash backward; the first is
# olmo-1b's training step (l) (the main row)
FLASH_BWD_SHAPES = (
    ("bwd olmo-1b B=8 S=T=512 H=KV=16", 8, 16, 16, 512, 512, 128, True),
    ("bwd qwen2-vl-7b G=7 H=28 KV=4 S=T=512", 8, 28, 4, 512, 512, 128,
     True),
    ("bwd whisper-tiny cross attention B=8 S=448 T=1500 H=KV=6 dh=64", 8, 6,
     6, 448, 1500, 64, False),
)


# --- the mesh slice: command-r-35b through launch.serve's --mesh host -------------

MESH_ARGV = ["--mesh", "host", "--full", "--arch", "command-r-35b",
             "--greedy"]


def mesh_trace(rt, cfg):
    """(n)'s seeded trace: 8 requests, prompts 128-512, generations
    32-64."""
    return rt.poisson_trace(8, mean_interarrival=4.0,
                            prompt_lens=(128, 256, 384, 512),
                            gen_lens=(32, 48, 64),
                            vocab_size=cfg.vocab_size, seed=0)


def param_leaves(tree) -> list:
    return [x for v in tree.values()
            for x in (param_leaves(v) if isinstance(v, dict) else [v])]


def step_bound(cfg, params, B: int, ctx: int):
    """The bound of one decode step of ``B`` slots at ``ctx`` cached
    tokens: every weight read once but an untied embedding, of which only
    the B rows looked up (a tied one is read whole as the head), each
    slot's K/V read and its new row written, the f32 logits written;
    beside the products' operations (no lookup's). Returns ((ms, "bytes"
    or "operations"), bytes)."""
    weights = sum(t.numel() * t.element_size() for t in param_leaves(params))
    products = cfg.param_count()
    if not cfg.tie_embeddings:
        emb = params["embed"]
        weights -= (emb.shape[0] - B) * emb.shape[1] * emb.element_size()
        products -= emb.numel()
    kv = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 2
    nbytes = weights + B * (ctx + 1) * kv + B * cfg.vocab_size * 4
    flops = 2 * B * products + 4 * B * cfg.num_layers \
        * cfg.num_heads * (ctx + 1) * cfg.head_dim
    return bound(flops, nbytes), nbytes


def phase_mesh(torch, serve, rt, ops, ref, L, T, get_config):
    """(n) command-r-35b at full width and depth through launch.serve's
    ``--mesh host`` (a real 1x1 DeviceMesh on nccl): the engine on (b)'s
    settings and an 8-request trace, every launch counter zeroed just
    before and read just after, the eager twin, three requests
    teacher-forced, the peak memory; (n') its graphed step beside the
    step's bytes bound. ``--mesh pod`` must raise on one card first.
    Returns the launch counts of the engine run."""
    from repro_torch.launch.mesh import installed
    print("== (n) launch.serve --mesh, command-r-35b full width and depth",
          flush=True)
    try:
        serve.main(["--mesh", "pod"])
    except RuntimeError as e:
        assert "256 ranks" in str(e), e
        print(f"  --mesh pod on one card raises: {e}", flush=True)
    else:
        raise AssertionError("--mesh pod served on one card")
    args = serve.parse_args(MESH_ARGV)
    cfg = get_config(args.arch)
    mesh = serve.make_serving_mesh(args)
    try:
        with installed(mesh):
            print(f"  mesh {mesh.shape} backend {mesh.backend} (DeviceMesh "
                  f"{mesh.device_mesh.device_type})", flush=True)
            assert mesh.size == 1 and mesh.backend == (
                "nccl" if DEV == "cuda" else "gloo")
            torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            params = serve.init_params(cfg, args, mesh)
            torch.cuda.synchronize()
            print(f"  serve.init_params {cfg.name}: "
                  f"{time.monotonic() - t0:.1f} s, "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB",
                  flush=True)
            counts = mesh_engine(torch, rt, ops, ref, L, T, cfg, params)
            busy = phase_horizon(torch, rt, ops, cfg, params, "(n')", h=8)
            (b_ms, by), nbytes = step_bound(cfg, params, 8, 404)
            print("  graphed decode step: device busy "
                  + (f"{busy['graphed']:.3f} ms" if busy["graphed"]
                     else "not measured")
                  + f" against a {by} bound of {b_ms:.3f} ms "
                  f"({nbytes / 1e9:.2f} GB at {PEAK_BYTES_PER_S / 1e12:.2f}"
                  f" TB/s; B 8, 404 cached tokens)", flush=True)
            del params
    finally:
        mesh.close()
    return counts


def mesh_engine(torch, rt, ops, ref, L, T, cfg, params) -> dict:
    """(n)'s engine run with the counters zeroed and read, its checks and
    its eager twin. Returns the launch counts."""
    ecfg = engine_config(rt)
    trace = mesh_trace(rt, cfg)
    counters = ops.launch_counters()
    calls, restore = plain_calls(ref, L)
    engine = rt.Engine(cfg, params, ecfg)
    for c in counters:
        c.launches = 0
    try:
        rep, rise = run_counted(torch, engine, trace)
    finally:
        restore()
    counts = {c.__name__: c.launches for c in counters}
    assert counts == rise
    summary = rep.summary()
    print(json.dumps(summary), flush=True)
    want = {"paged_decode_attention": cfg.num_layers * rep.decode_steps,
            "flash_attention": cfg.num_layers * rep.prefill_calls}
    print(f"  launches {counts}; plain versions called {calls}", flush=True)
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert not any(calls.values()), calls
    print_graph(engine.backend.graph, rep)
    finish_check(rep, trace, cfg)
    print_rates(rep, summary)
    del engine
    eager_twin(torch, rt, cfg, params, ecfg, trace, rep, rise)
    worst, scale = 0.0, 0.0
    for r in rep.completed[:3]:
        worst = max(worst, greedy_gap(torch, T, cfg, params, r))
        seq = torch.tensor([list(r.prompt)], device=DEV)
        scale = max(scale, T.forward(cfg, params, {"tokens": seq})
                    .abs().max().item())
    print(f"  teacher-forced greedy gap {worst:.4e} (logit scale "
          f"{scale:.3e}) over requests "
          f"{[r.rid for r in rep.completed[:3]]}", flush=True)
    assert worst <= 16 * 2.0 ** -8 * max(scale, 1.0), worst
    print(f"  peak card memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          " GiB", flush=True)
    return counts


# --- the mesh slice of the other families: launch.serve / launch.train --mesh host --

# (arch, mode, prompt length, generation length) of (o): (b)'s prompt and
# generation lengths (the entry point's trace: prompts of half to all of
# --prompt-len, generations of a quarter to all of --gen); the engine
# sizes its tables from prompt + gen, as the reference does, so
# recurrentgemma's 2,048-token window ring fits only beside 2,048-token
# prompts (pages of 512, a ring of 5 rows)
FAMILY_MESH = [("qwen2-vl-7b", "engine", 512, 128),
               ("rwkv6-7b", "engine", 512, 128),
               ("recurrentgemma-9b", "engine", 2048, 128),
               ("whisper-tiny", "static", 512, 128)]
FAMILY_TRAIN = ("rwkv6-7b", 2, 3)          # (arch, layers, steps) of (o')


def family_argv(arch, mode, prompt, gen) -> list[str]:
    return ["--mesh", "host", "--full", "--arch", arch, "--mode", mode,
            "--greedy", "--batch", "4", "--requests", "4", "--prompt-len",
            str(prompt), "--gen", str(gen)]


class _Recorded:
    """What the entry point ran, for (o)'s unsharded twin: the engine's
    params, config and report, or the static mode's params and the
    tokens it fed each decode step."""

    def __init__(self):
        self.params = self.ecfg = self.rep = None
        self.fed = []


def recording(serve, api, rec: _Recorded):
    """Patch ``serve.Engine`` and the model module's ``decode_step`` (the
    one ``api``, ``get_model``'s, reads) to record into ``rec``; returns
    the undo."""
    model = sys.modules[api.decode_step.__module__]
    engine, step = serve.Engine, model.decode_step

    class Engine(engine):
        def run(self, requests):
            rec.params, rec.ecfg = self.backend.params, self.ecfg
            rec.rep = super().run(requests)
            return rec.rep

    def decode_step(cfg, params, state, tokens):
        rec.params = params
        rec.fed.append(tokens.clone())
        return step(cfg, params, state, tokens)

    serve.Engine, model.decode_step = Engine, decode_step

    def undo():
        serve.Engine, model.decode_step = engine, step
    return undo


def mesh_launches(cfg, mode: str, rep=None, steps: int = 0) -> dict:
    """The kernel launches a ``serve.main --mesh host`` run of ``cfg``
    makes: an engine run's from its report ``rep`` (qwen2-vl's paged
    decode a layer a step and flash a layer a prefill; deepseek's three
    grouped products a layer a step and a prefill; none for rwkv6 and
    recurrentgemma), a static run's from its ``steps`` decode steps
    (whisper's dense decode twice a layer a step and flash at its
    encoder and prefill; olmoe's dense decode a layer a step, flash a
    layer at its prefill and three grouped products a layer a step and
    at the prefill)."""
    Lc = cfg.num_layers
    if mode == "engine":
        if cfg.family == "vlm":
            return {"paged_decode_attention": Lc * rep.decode_steps,
                    "flash_attention": Lc * rep.prefill_calls}
        if cfg.family == "moe":
            return {"grouped_mvm": 3 * Lc * (rep.decode_steps
                                             + rep.prefill_calls)}
        return {}
    if cfg.family == "encdec":
        return {"decode_attention": 2 * Lc * steps,
                "flash_attention": cfg.encoder.num_layers + 2 * Lc}
    return {"decode_attention": Lc * steps, "flash_attention": Lc,
            "grouped_mvm": 3 * Lc * (steps + 1)}


def serve_mesh_runs(torch, serve, rt, ops, get_config, get_model, smi: str,
                    runs) -> dict:
    """``launch.serve.main --mesh host --full`` (a 1x1 DeviceMesh on
    nccl) of each (arch, mode, prompt, gen) of ``runs``, 4 greedy
    requests and 4 slots (4 rows) each, every kernel counter zeroed just
    before and read just after and held to ``mesh_launches``; the same
    params and prompts through the unsharded path (no mesh installed)
    must give the same tokens bit for bit, as every collective at 1x1 is
    the identity. Prints decode tokens/s beside the card's name and
    power limit; frees the card after each arch. Returns the launch
    counts by kernel."""
    counters = ops.launch_counters()
    launches = {c.__name__: 0 for c in counters}
    for arch, mode, prompt, gen in runs:
        argv = family_argv(arch, mode, prompt, gen)
        args = serve.parse_args(argv)
        cfg = get_config(arch)
        api = get_model(cfg)
        rec = _Recorded()
        undo = recording(serve, api, rec)
        for c in counters:
            c.launches = 0
        try:
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = run_captured(torch, lambda: serve.main(argv))
            wall = time.monotonic() - t0
        finally:
            undo()
        counts = {c.__name__: c.launches for c in counters}
        assert out[-1] == "ok", out
        if mode == "engine":
            rep = rec.rep
            summary = rep.summary()
            print(f"  {arch} {' '.join(argv)}: wall {wall:.1f} s (init "
                  f"included), {summary['new_tokens']} tokens in "
                  f"{summary['decode_steps']} decode steps, decode "
                  f"tokens/s {summary['tokens_per_s']}; {smi}", flush=True)
            want = mesh_launches(cfg, mode, rep=rep)
            ecfg, trace = serve.engine_setup(cfg, args)
            twin = rt.Engine(cfg, rec.params, rec.ecfg).run(trace)
            got = {r.rid: r.generated for r in rep.completed}
            ref = {r.rid: r.generated for r in twin.completed}
            assert len(got) == len(trace) and got == ref, (got, ref)
            print(f"  unsharded twin: the same {len(got)} requests' tokens "
                  f"bit for bit ({sum(map(len, got.values()))} tokens)",
                  flush=True)
        else:
            fed = torch.stack(rec.fed, 1)
            steps = fed.shape[1]
            dt = wall / max(steps, 1) * 1e3
            print(f"  {arch} {' '.join(argv)}: wall {wall:.1f} s (init "
                  f"included), {steps} decode steps of B {args.batch}, "
                  f"{dt:.1f} ms a step with init and prefill; {smi}",
                  flush=True)
            for line in out:
                if line.startswith("prefill:"):
                    ms = float(line.split("decode:")[1].split("ms")[0])
                    print(f"  {line}: decode tokens/s "
                          f"{args.batch * 1e3 / ms:.1f}; {smi}", flush=True)
            want = mesh_launches(cfg, mode, steps=steps)
            twin = _Recorded()
            undo = recording(serve, api, twin)
            try:
                run_captured(torch, lambda: serve.run_static_mode(
                    cfg, rec.params, args))
            finally:
                undo()
            assert torch.equal(torch.stack(twin.fed, 1), fed)
            print(f"  unsharded twin: the same {fed.numel()} tokens bit for "
                  f"bit", flush=True)
        print(f"  launches {counts}", flush=True)
        assert counts == {k: want.get(k, 0) for k in counts}, (counts, want)
        for k, n in counts.items():
            launches[k] += n
        del rec, twin
        free_card(torch)
    return launches


def phase_family_mesh(torch, serve, train, rt, ops, get_config, get_model,
                      smi: str) -> dict:
    """(o) the mesh slice of the vlm, ssm, hybrid and encoder-decoder
    families on one card (``serve_mesh_runs``): qwen2-vl-7b, rwkv6-7b
    and recurrentgemma-9b through the engine and whisper-tiny static.
    (o') ``launch.train.main --mesh host`` on rwkv6-7b at full width cut
    to 2 layers, 3 steps: its step-1 loss must equal the cut run's
    without a mesh (``build_config``) bit for bit. Returns the launch
    counts by kernel."""
    print("== (o) launch.serve --mesh host, the vlm, ssm, hybrid and "
          "encdec families at full width", flush=True)
    launches = serve_mesh_runs(torch, serve, rt, ops, get_config, get_model,
                               smi, FAMILY_MESH)
    family_train(torch, train, get_config, smi)
    return launches


# (p)'s runs: olmoe static at B 4 x 512 + 128, deepseek on the engine
# (4 slots, prompts 256-512, generations 32-128)
MOE_MESH = [("olmoe-1b-7b", "static", 512, 128),
            ("deepseek-v2-lite-16b", "engine", 512, 128)]


def phase_moe_mesh(torch, serve, rt, ops, get_config, get_model,
                   smi: str) -> dict:
    """(p) the mesh slice of the MoE family (expert-parallel experts,
    head-parallel MLA, group-local dispatch; identities at 1x1) on one
    card at full width and depth (``serve_mesh_runs``): olmoe-1b-7b
    static (row 2's flash at its prefill, row 8's dense decode and row
    7's grouped products) and deepseek-v2-lite-16b on the engine (row 7),
    each against its unsharded twin bit for bit. Returns the launch
    counts by kernel."""
    print("== (p) launch.serve --mesh host, the MoE family at full width "
          "and depth", flush=True)
    return serve_mesh_runs(torch, serve, rt, ops, get_config, get_model,
                           smi, MOE_MESH)


def family_train(torch, train, get_config, smi: str) -> None:
    """(o') rwkv6-7b at full width cut in depth through
    ``launch.train.main --mesh host`` against the same cut run without a
    mesh: step-1 loss bit for bit, every loss finite."""
    import shutil
    import tempfile
    arch, layers, n_steps = FAMILY_TRAIN
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    print(f"== (o') launch.train --mesh host, {arch} full width cut to "
          f"{layers} layers, {n_steps} steps", flush=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_o_", dir=ROOT / "build")
    argv = ["--mesh", "host", "--arch", arch, "--full", "--steps",
            str(n_steps), "--seq-len", "512", "--batch", "8",
            "--ckpt-every", "1000", "--log-every", "1", "--ckpt-dir", tmp]
    seen = []
    get, run = train.get_config, train.train

    def recorded(args, mesh):
        seen.append(run(args, mesh))
        return seen[-1]
    train.get_config, train.train = (lambda a: cfg), recorded
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rc = train.main(argv)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    finally:
        train.get_config, train.train = get, run
        shutil.rmtree(tmp, ignore_errors=True)
    (losses,) = seen
    print(f"  train.main {' '.join(argv[:-2])}: rc {rc}, losses {losses}, "
          f"wall {wall:.1f} s ({wall / n_steps * 1e3:.0f} ms a step with "
          f"init); {smi}", flush=True)
    assert len(losses) == n_steps and all(map(math.isfinite, losses))
    free_card(torch)
    _, params, opt, stream, step_fn = train.build_config(
        cfg, seq_len=512, batch=8, lr=3e-4, steps=n_steps, microbatches=1,
        device=DEV)
    _, _, metrics = step_fn(params, opt, stream.batch(0))
    one = float(metrics["loss"])
    print(f"  the cut run without a mesh: step-1 loss {one!r} (the mesh "
          f"run's {losses[0]!r})", flush=True)
    assert one == losses[0], (one, losses[0])
    del params, opt
    free_card(torch)


def phase_flash_bwd(torch, fa, ref, parent=None):
    """(l0) the flash backward against its plain versions at the training
    paths' shapes: the kernel forward's log-sum-exp against
    ``ref.attention_lse``, each of the three launches (row-dot, dK/dV,
    dQ) against its plain version on the same inputs, and the whole
    backward against autograd through ``ref.mha_attention`` in f32 from
    the same bf16 inputs and a fixed upstream dO; each gradient within TOL
    element by element and within GRAD_REL as a whole; a second backward
    repeats bit for bit. Times each launch and the whole beside its bound
    (five products; bf16 tensors read or written once), its TFLOP/s over
    the visible pairs (seven products in all: dK/dV's four, dQ's three),
    the plain versions, the SDPA backward on the same inputs (SDPA's
    forward and backward, less its forward) and (given the parent's ops)
    the parent tree's three launches and whole backward, parent, this
    tree, this tree, parent. Returns the three kernels' records (launches
    filled in by (l)); the dK/dV record also carries the whole backward's
    time, bound and plain time and the SDPA backward's at the first
    shape."""
    import torch.nn.functional as F

    print("== (l0) flash backward vs plain versions", flush=True)
    pfa = None if parent is None else importlib.import_module(
        parent.__name__.rsplit(".", 1)[0] + ".flash_attention")
    if not hasattr(pfa, "flash_bwd_dq"):         # a tree without them
        pfa = None
    rows, errs = {}, dict.fromkeys(("rowdot", "dkdv", "dq"), 0.0)
    rels = dict.fromkeys(("dkdv", "dq"), 0.0)
    for name, B, H, KV, S, T, dh, causal in FLASH_BWD_SHAPES:
        (q, k, v), fwd_flops, _ = flash_case(torch, B, H, KV, S, T, 0, dh,
                                             causal)
        gen = torch.Generator(device=DEV).manual_seed(1)
        do = torch.randn(q.shape, generator=gen, device=DEV
                         ).to(torch.bfloat16)
        qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
        with torch.no_grad():
            out, lse = fa.flash_attention(qt, kt, vt, return_lse=True,
                                          causal=causal)
        compare(torch, lse, ref.attention_lse(q, k, causal=causal),
                f"{name} lse", dict(rtol=1e-5, atol=1e-4))
        ot = out.transpose(1, 2)
        delta = fa.flash_bwd_rowdot(out, dot)
        dk, dv = fa.flash_bwd_dkdv(qt, kt, vt, dot, lse, delta,
                                   causal=causal)
        dq = fa.flash_bwd_dq(qt, kt, vt, dot, lse, delta, causal=causal)
        errs["rowdot"] = max(errs["rowdot"], compare(
            torch, delta, ref.flash_bwd_rowdot(ot, do), f"{name} rowdot",
            dict(rtol=1e-4, atol=1e-3)))
        wk, wv = ref.flash_bwd_dkdv(q, k, v, do, lse, delta, causal=causal)
        wq = ref.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal)
        launch = {what: compare_grad(torch, got.transpose(1, 2), want,
                                     f"{name} {what}")
                  for what, got, want in (("dq", dq, wq), ("dk", dk, wk),
                                          ("dv", dv, wv))}
        for kname, whats in (("dkdv", ("dk", "dv")), ("dq", ("dq",))):
            for what in whats:
                errs[kname] = max(errs[kname], launch[what][0])
                rels[kname] = max(rels[kname], launch[what][1])
        del wq, wk, wv

        def plain_bwd():
            ts = [t.float().requires_grad_() for t in (q, k, v)]
            ref.mha_attention(*ts, causal=causal).backward(do.float())
            return [t.grad for t in ts]
        whole = {what: compare_grad(torch, got.transpose(1, 2), want,
                                    f"{name} {what} (whole backward)")
                 for got, want, what in zip((dq, dk, dv), plain_bwd(),
                                            ("dq", "dk", "dv"))}
        again = fa.flash_attention_bwd(qt, kt, vt, out, dot, lse,
                                       causal=causal)
        assert torch.equal(delta, fa.flash_bwd_rowdot(out, dot)) and all(
            torch.equal(a, b) for a, b in zip(again, (dq, dk, dv))), \
            f"{name}: a second backward differs"
        del again

        # times: each launch and the whole backward, of this tree and
        # (given) the parent's in turns, then the plain versions
        def times(mod):
            return {"rowdot": cuda_ms(torch, lambda: mod.flash_bwd_rowdot(
                        out, dot), iters=50, hide_host=True),
                    "dkdv": cuda_ms(torch, lambda: mod.flash_bwd_dkdv(
                        qt, kt, vt, dot, lse, delta, causal=causal),
                        iters=20, hide_host=True),
                    "dq": cuda_ms(torch, lambda: mod.flash_bwd_dq(
                        qt, kt, vt, dot, lse, delta, causal=causal),
                        iters=20, hide_host=True),
                    "whole": cuda_ms(torch, lambda: mod.flash_attention_bwd(
                        qt, kt, vt, out, dot, lse, causal=causal), iters=20,
                        hide_host=True)}
        if pfa is None:
            t = times(fa)
        else:
            old = [times(pfa)]
            t = times(fa)
            t2 = times(fa)
            old.append(times(pfa))
            t = {kn: min(t[kn], t2[kn]) for kn in t}
            old = {kn: min(o[kn] for o in old) for kn in t}
        whole_ms = t.pop("whole")
        plain = {"rowdot": cuda_ms(torch, lambda: ref.flash_bwd_rowdot(
                     ot, do), iters=5),
                 "dkdv": cuda_ms(torch, lambda: ref.flash_bwd_dkdv(
                     q, k, v, do, lse, delta, causal=causal), iters=3,
                     warmup=1),
                 "dq": cuda_ms(torch, lambda: ref.flash_bwd_dq(
                     q, k, v, do, lse, delta, causal=causal), iters=3,
                     warmup=1)}
        plain_whole = cuda_ms(torch, plain_bwd, iters=3, warmup=1)
        # the library: SDPA forward + backward, less its forward
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=H != KV)
        sdpa_fwd = cuda_ms(torch, sdpa, iters=20, hide_host=True)
        sdpa_both = cuda_ms(torch, lambda: torch.autograd.grad(
            sdpa(), (qs, ks, vs), dot), iters=20, hide_host=True)
        sdpa_bwd = sdpa_both - sdpa_fwd
        del qs, ks, vs
        # bounds: fwd_flops counts 2 products over the visible pairs; bf16
        # tensors read or written once each, lse and D in f32
        n_q, n_k, n_s = q.numel(), k.numel(), B * H * S
        flops = {"rowdot": 2 * n_q, "dkdv": 4 * fwd_flops // 2,
                 "dq": 3 * fwd_flops // 2}
        nbytes = {"rowdot": 2 * 2 * n_q + 4 * n_s,
                  "dkdv": 2 * (2 * n_q + 4 * n_k) + 8 * n_s,
                  "dq": 2 * (3 * n_q + 2 * n_k) + 8 * n_s}
        bounds = {kname: bound(flops[kname], nbytes[kname])
                  for kname in flops}
        b_whole = bound(5 * fwd_flops // 2,
                        2 * (4 * n_q + 4 * n_k) + 4 * n_s)
        tflops = {kname: flops[kname] / t[kname] / 1e9 for kname in t}
        old_txt = {kname: "" if pfa is None else f", parent {old[kname]:.4f}"
                   for kname in (*t, "whole")}
        print(f"  {name}: relative Frobenius error (limit {GRAD_REL}) "
              f"per launch " + ", ".join(
                  f"{w} {launch[w][1]:.3e}" for w in launch) + "; whole " +
              ", ".join(f"{w} {whole[w][1]:.3e}" for w in whole) +
              f"; max_abs_err whole "
              f"{max(e for e, _ in whole.values()):.3e}; backward "
              f"{whole_ms:.4f} ms ({3.5 * fwd_flops / whole_ms / 1e9:.0f} "
              f"TFLOP/s over the visible pairs; bound {b_whole[0]:.4f} ms, "
              f"{b_whole[1]}{old_txt['whole']}; plain {plain_whole:.4f} ms; "
              f"sdpa backward {sdpa_bwd:.4f} ms = {sdpa_both:.4f} forward + "
              f"backward - {sdpa_fwd:.4f} forward)\n    " + "  ".join(
                  f"{kname} {t[kname]:.4f} ms ({tflops[kname]:.0f} TFLOP/s; "
                  f"bound {bounds[kname][0]:.4f} {bounds[kname][1]}"
                  f"{old_txt[kname]}, plain {plain[kname]:.4f})"
                  for kname in t), flush=True)
        if not rows:
            # no library call computes one launch's function; the whole
            # backward and SDPA's backward ride on the dK/dV row
            rows = {kname: dict(ms=t[kname], plain_ms=plain[kname],
                                bound_ms=bounds[kname][0],
                                bound_by=bounds[kname][1], library_ms=None)
                    for kname in t}
            rows["dkdv"].update(whole_ms=whole_ms,
                                whole_bound_ms=b_whole[0],
                                whole_plain_ms=plain_whole,
                                library_whole_ms=sdpa_bwd)
            if pfa is not None:
                for kname in rows:
                    rows[kname]["parent_ms"] = old[kname]
                rows["dkdv"]["parent_whole_ms"] = old["whole"]
        del q, k, v, do, out, lse, delta, dq, dk, dv
    free_card(torch)
    src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    out = [dict(name=f"flash_bwd_{kname}", route="cuda", source=src,
                replaces="src/repro/kernels/flash_attention.py:103",
                counter=getattr(fa, f"flash_bwd_{kname}"),
                max_abs_err=errs[kname], **rows[kname])
           for kname in ("rowdot", "dkdv", "dq")]
    for k in out[1:]:
        k["max_rel_err"] = rels[k["name"].removeprefix("flash_bwd_")]
    return out


# olmo-1b at full width and depth, B 8 x 512 tokens; the checkpoint of
# step 12 is the one the resume starts from
TRAIN_STEPS, TRAIN_CKPT = 20, 12
TRAIN_ARGV = ["--mesh", "host", "--arch", "olmo-1b", "--full", "--seq-len",
              "512", "--batch", "8", "--ckpt-every", str(TRAIN_CKPT),
              "--log-every", "1"]


def recording_build(build, record):
    """``build`` (``train.build``) whose step function appends each
    step's (loss, pre-clip gradient norm) to ``record`` at full
    precision."""
    def wrapped(*a, **kw):
        cfg, params, opt, stream, step = build(*a, **kw)

        def step_fn(p, o, batch):
            p, o, m = step(p, o, batch)
            record.append((float(m["loss"]), float(m["grad_norm"])))
            return p, o, m
        return cfg, params, opt, stream, step_fn
    return wrapped


def optimizer_sample(leaves, state) -> list:
    """Host copies of a (params, AdamW state) tree's step count and of the
    first and last non-empty leaves of its m and v."""
    _, opt = state
    out = [opt.step.clone()]
    for tree in (opt.m, opt.v):
        full = [t for t in leaves(tree) if t.numel()]
        out += [full[0].detach().cpu().clone(),
                full[-1].detach().cpu().clone()]
    return out


def timed_checkpoints(ckpt, leaves):
    """Wrap ``CheckpointManager.save`` / ``restore`` to time each call
    and to keep ``optimizer_sample`` of the tree each one saved or
    returned (taken at the call: the train step updates in place);
    returns (times {"save": [...], "restore": [...]}, samples of the same
    keys, undo)."""
    cls = ckpt.CheckpointManager
    saved = {"save": cls.save, "restore": cls.restore}
    times = {"save": [], "restore": []}
    samples = {"save": [], "restore": []}

    def timed(name):
        def call(self, *a, **kw):
            t0 = time.monotonic()
            out = saved[name](self, *a, **kw)
            times[name].append(time.monotonic() - t0)
            samples[name].append(optimizer_sample(
                leaves, a[1] if name == "save" else out[0]))
            return out
        return call
    for name in saved:
        setattr(cls, name, timed(name))

    def undo():
        for name, fn in saved.items():
            setattr(cls, name, fn)
    return times, samples, undo


def recording_mesh(make, meshes):
    """``make`` (``train.make_training_mesh``) appending each mesh it
    makes to ``meshes``."""
    def wrapped(args):
        meshes.append(make(args))
        return meshes[-1]
    return wrapped


def phase_train(torch, train, ckpt, ops, ref, L, kernels, bwd_kernels):
    """(l) ``repro_torch.launch.train.main`` on the card through ``--mesh
    host`` (a real 1x1 DeviceMesh on nccl, whose shape and backend it
    prints; ``--mesh pod`` must raise on one card first): olmo-1b at full
    width and depth (1.18 B parameters, f32 masters and AdamW state,
    remat), 20 steps of B 8 x 512 tokens, a checkpoint at step 12 in a
    temporary directory under build/. Every kernel counter is zeroed just
    before and read just after: 32 flash forward launches a step (16, and
    16 again in the recomputed blocks), 16 of each backward launch,
    nothing else, and no plain attention called. The loss must fall and
    every step's gradient norm be finite (so no gradient holds a NaN or
    an Inf). Then ``main`` again in the same directory for one step: it
    resumes from step 12, step 13's loss equals the first run's bit
    for bit (the kernels have no atomics; its gradient norm is printed
    beside the first run's), and the
    restored AdamW step count and a sample of its m and v equal what was
    saved, bit for bit. Then one step's breakdown on
    a fresh ``build``: host enqueue against device busy, ms/step,
    tokens/s, model FLOPs over 989 TFLOP/s, peak memory. The flash
    forward's row of the kernels line gains ``launches_train``, the
    backward's rows their launches here."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import leaves

    (ROOT / "build").mkdir(exist_ok=True)
    ckdir = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=ROOT / "build")
    argv = [*TRAIN_ARGV, "--steps", str(TRAIN_STEPS), "--ckpt-dir", ckdir,
            "--device", DEV]
    args = train.parse_args(argv)
    cfg = get_config(args.arch) if args.full else \
        get_config(args.arch).reduced()
    print(f"== (l) launch.train {' '.join(argv)}", flush=True)
    try:
        train.main(["--mesh", "pod"])
    except RuntimeError as e:
        assert "256 ranks" in str(e), e
        print(f"  --mesh pod on one card raises: {e}", flush=True)
    else:
        raise AssertionError("--mesh pod trained on one card")
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    first, again, meshes = [], [], []
    times, samples, undo_times = timed_checkpoints(ckpt, leaves)
    counters = ops.launch_counters()
    build, make_mesh = train.build, train.make_training_mesh
    try:
        train.build = recording_build(build, first)
        train.make_training_mesh = recording_mesh(make_mesh, meshes)
        for c in counters:
            c.launches = 0
        calls, restore = plain_calls(ref, L)
        digests, undo_digests = first_gradients(steps)
        t0 = time.monotonic()
        try:
            out = run_captured(torch, lambda: train.main(argv))
        finally:
            restore()
            undo_digests()
        wall = time.monotonic() - t0
        counts = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        free_card(torch)
        train.build = recording_build(build, again)
        # one step: its last loss is its first, so main returns 1
        resumed = run_captured(torch, lambda: train.main(
            [*TRAIN_ARGV, "--steps", "1", "--ckpt-dir", ckdir, "--device",
             DEV]), rc_want=1)
    finally:
        train.build, train.make_training_mesh = build, make_mesh
        undo_times()
        shutil.rmtree(ckdir, ignore_errors=True)
    for mesh in meshes:
        print(f"  mesh {mesh.shape} backend {mesh.backend} (DeviceMesh "
              f"{mesh.device_mesh.device_type})", flush=True)
    assert len(meshes) == 2 and all(
        m.size == 1 and m.backend == ("nccl" if DEV == "cuda" else "gloo")
        for m in meshes), meshes
    for line in out:
        print(f"  {line}")
    for line in resumed:
        print(f"  (resumed) {line}")
    print_digests(cfg.name, digests)
    steps, layers = args.steps, cfg.num_layers
    want = {"flash_attention": 2 * layers * steps,
            **{f"flash_bwd_{n}": layers * steps
               for n in ("rowdot", "dkdv", "dq")}}
    print(f"  launches {counts}; plain versions called {calls}; entry "
          f"point wall {wall:.1f} s (init included); checkpoint save "
          f"{sum(times['save']):.1f} s, restore "
          f"{sum(times['restore']):.1f} s; peak memory {peak:.1f} GiB",
          flush=True)
    assert counts == {k: want.get(k, 0) for k in counts}, counts
    assert not any(calls.values()), calls
    assert out[-1].startswith(f"done: {steps} steps, 0 retries"), out[-1]
    assert len(first) == steps and len(again) == 1, (first, again)
    assert first[-1][0] < first[0][0], first
    assert all(math.isfinite(g) for _, g in first + again), first + again
    assert resumed[0] == f"resumed from step {TRAIN_CKPT}", resumed
    assert len(times["save"]) == 1 and len(times["restore"]) == 1, times
    print(f"  loss {first[0][0]:.4f} -> {first[-1][0]:.4f}; step "
          f"{TRAIN_CKPT + 1}: {first[TRAIN_CKPT][0]!r} uninterrupted, "
          f"{again[0][0]!r} resumed", flush=True)
    print(f"  step {TRAIN_CKPT + 1}'s gradient norm: "
          f"{first[TRAIN_CKPT][1]!r} uninterrupted, {again[0][1]!r} resumed",
          flush=True)
    assert again[0][0] == first[TRAIN_CKPT][0], (again, first[TRAIN_CKPT])
    (kept,), (back,) = samples["save"], samples["restore"]
    print(f"  AdamW state restored at step {int(back[0])}: m and v leaves "
          f"{[tuple(t.shape) for t in back[1:]]} equal to the saved "
          f"bit for bit: {all(torch.equal(a, b) for a, b in zip(kept, back))}",
          flush=True)
    assert int(kept[0]) == int(back[0]) == TRAIN_CKPT, (kept[0], back[0])
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(kept, back)), "AdamW state not restored"
    for k in bwd_kernels:
        del k["counter"]
        k["launches"] = counts[k["name"]]
        assert k["launches"] > 0, f"{k['name']} never ran on the main path"
    for k in kernels:
        if k["name"] == "flash_attention":
            k["launches_train"] = counts["flash_attention"]

    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    _, params, opt, stream, step = train.build(
        args.arch, reduced=not args.full, seq_len=args.seq_len,
        batch=args.batch,
        lr=args.lr, steps=args.steps, microbatches=1, device=DEV)
    batch = stream.batch(0)
    state = [params, opt]

    def one():
        state[0], state[1], m = step(state[0], state[1], batch)
        return m
    one()
    torch.cuda.synchronize()
    # the wall before the profiler runs: steps after it ran slower
    t0 = time.monotonic()
    for _ in range(3):
        m = one()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) / 3 * 1e3
    busy = breakdown(torch, f"train step {cfg.name} B={args.batch} "
                     f"S={args.seq_len}", one, steps=3)
    # model FLOPs: 6 a parameter a token (the tied head counted once,
    # attention's own products not counted)
    tokens = args.batch * args.seq_len
    n_params = sum(t.numel() for t in leaves(state[0]))
    flops = 6.0 * n_params * tokens
    print(f"  train step {ms:.1f} ms ({busy:.1f} ms device busy), "
          f"{n_params / 1e9:.3f} B parameters, "
          f"{tokens / ms * 1e3:.0f} tokens/s, model FLOPs {flops:.3e} a "
          f"step = {flops / (ms / 1e3) / PEAK_BF16_FLOPS:.3f} of 989 "
          f"TFLOP/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; loss "
          f"{float(m['loss']):.4f}", flush=True)
    del state, params, opt, batch, m
    free_card(torch)


def leaf_names(tree, prefix="") -> list:
    """A param tree's leaf paths in ``optim.adamw.leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                             f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def leaf_digest(torch, t) -> str:
    """An order-free digest of an f32 tensor's bits: the sum of its 32-bit
    words as integers, modulo 2^64, in hex. One changed element changes
    it, so two calls' digests tell which leaf first differs."""
    words = t.detach().contiguous().view(-1).view(torch.int32)
    total = sum(int(part.sum(dtype=torch.int64))
                for part in words.split(1 << 26))
    return f"{total % 2**64:016x}"


def first_gradients(steps):
    """Wrap ``steps.adamw_update`` so that its first call keeps the digest
    of every gradient leaf, by path (the train step's gradients before the
    clip, which ``adamw_update`` applies in place); returns (digests,
    undo)."""
    update, digests = steps.adamw_update, {}

    def recorded(params, grads, opt, **kw):
        if not digests:
            import torch
            for name, g in zip(leaf_names(params), grads):
                digests[name] = leaf_digest(torch, g)
        return update(params, grads, opt, **kw)
    steps.adamw_update = recorded

    def undo():
        steps.adamw_update = update
    return digests, undo


def print_digests(label: str, digests: dict) -> None:
    print(f"  {label} step-1 gradient digests (sum of f32 words mod 2^64): "
          + ", ".join(f"{k} {v}" for k, v in digests.items()), flush=True)


# --- MoE training: the grouped GEMM's backward and the MoE train step -----------------

# (label, E, C, D, F, routed tokens, top-k) of the grouped GEMM's backward:
# the live rows of each expert come from a seeded top-k routing of that many
# tokens (clamped to C), and one expert has none. olmoe-1b-7b's training
# shapes at B 8 x 512 (C 640 of moe_dims; gate/up D 2048 -> F 1024, and the
# down product), deepseek-v2-lite-16b's (C 512, F 1408), and a C off the
# 128-row tile; the first is the kernels record's row
GROUPED_BWD_SHAPES = (
    ("olmoe gate/up", 64, 640, 2048, 1024, 4096, 8),
    ("olmoe down", 64, 640, 1024, 2048, 4096, 8),
    ("deepseek gate/up", 64, 512, 2048, 1408, 4096, 6),
    ("ragged C=60", 64, 60, 2048, 1408, 48, 6),
)


def phase_grouped_bwd(torch, ops, gm, ref, parent=None):
    """(m0) the grouped GEMM's backward kernels (dX = dY w^T, dW = x^T dY
    over the live rows) against their plain versions at the MoE training
    shapes, each within TOL and GRAD_REL, and the two together against
    autograd through ``ref.grouped_mvm`` in f32 from the same bf16 inputs;
    dead rows of dX and the dW of an expert with none are zeros; a second
    launch repeats bit for bit; ``ops.grouped_mvm`` under autograd runs
    one dX and one dW launch with the same bits. Times each launch beside
    its bound (live rows only), its TFLOP/s over the live rows, its plain
    version, ``torch.bmm``'s product on the same inputs and (given the
    parent's ops) the parent tree's ``grouped_mvm_bwd_dx`` / ``_dw``.
    Returns the two kernels' records (launches filled in by (m))."""
    print("== (m0) grouped GEMM backward vs plain versions", flush=True)
    old_gm = None if parent is None else importlib.import_module(
        parent.__name__.rsplit(".", 1)[0] + ".grouped_mvm")
    if not hasattr(old_gm, "grouped_mvm_bwd_dw"):    # a tree without them
        old_gm = None
    gen = torch.Generator(device=DEV).manual_seed(11)
    rows_out, errs, rels = {}, {"dx": 0.0, "dw": 0.0}, {"dx": 0.0, "dw": 0.0}
    for label, E, C, D, F, tokens, k in GROUPED_BWD_SHAPES:
        x = torch.randn((E, C, D), generator=gen, device=DEV
                        ).to(torch.bfloat16)
        w = (torch.randn((E, D, F), generator=gen, device=DEV) / D ** 0.5
             ).to(torch.bfloat16)
        dy = torch.randn((E, C, F), generator=gen, device=DEV
                         ).to(torch.bfloat16)
        rows = routed_rows(torch, gen, E, tokens, k).clamp_(max=C)
        rows[1] = 0
        got = {"dx": gm.grouped_mvm_bwd_dx(dy, w, rows),
               "dw": gm.grouped_mvm_bwd_dw(x, dy, rows)}
        torch.cuda.synchronize()
        want = {"dx": ref.grouped_mvm_bwd_dx(dy, w, rows),
                "dw": ref.grouped_mvm_bwd_dw(x, dy, rows)}
        xf, wf = (t.float().requires_grad_() for t in (x, w))
        ref.grouped_mvm(xf, wf, rows).backward(dy.float())
        exact = {"dx": xf.grad, "dw": wf.grad}
        res = {}
        for kn in ("dx", "dw"):
            assert torch.isfinite(got[kn]).all(), f"{label} {kn}: non-finite"
            e1, r1 = compare_grad(torch, got[kn], want[kn], f"{label} {kn}")
            e2, r2 = compare_grad(torch, got[kn], exact[kn],
                                  f"{label} {kn} (autograd)")
            errs[kn] = max(errs[kn], e1, e2)
            rels[kn] = max(rels[kn], r1, r2)
            res[kn] = (r1, r2)
        dead = torch.arange(C, device=DEV)[None, :] >= rows[:, None]
        assert not got["dx"][dead].any(), f"{label}: dX of a dead row"
        assert not got["dw"][rows == 0].any(), f"{label}: dW of no rows"
        assert torch.equal(gm.grouped_mvm_bwd_dx(dy, w, rows), got["dx"]) \
            and torch.equal(gm.grouped_mvm_bwd_dw(x, dy, rows), got["dw"]), \
            f"{label}: a second launch differs"
        n0 = (gm.grouped_mvm_bwd_dx.launches, gm.grouped_mvm_bwd_dw.launches)
        xa, wa = (t.clone().requires_grad_() for t in (x, w))
        ops.grouped_mvm(xa, wa, rows).backward(dy)
        assert (gm.grouped_mvm_bwd_dx.launches - n0[0],
                gm.grouped_mvm_bwd_dw.launches - n0[1]) == (1, 1)
        assert torch.equal(xa.grad, got["dx"]) and \
            torch.equal(wa.grad, got["dw"]), f"{label}: autograd route"
        del xf, wf, exact, xa, wa
        t = {"dx": cuda_ms(torch, lambda: gm.grouped_mvm_bwd_dx(dy, w, rows)),
             "dw": cuda_ms(torch, lambda: gm.grouped_mvm_bwd_dw(x, dy, rows))}
        plain = {"dx": cuda_ms(torch, lambda: ref.grouped_mvm_bwd_dx(
                     dy, w, rows), iters=3, warmup=1),
                 "dw": cuda_ms(torch, lambda: ref.grouped_mvm_bwd_dw(
                     x, dy, rows), iters=3, warmup=1)}
        wt = w.transpose(1, 2)
        xt = x.transpose(1, 2)
        lib = {"dx": cuda_ms(torch, lambda: torch.bmm(dy, wt)),
               "dw": cuda_ms(torch, lambda: torch.bmm(xt, dy))}
        old = {"dx": "", "dw": ""}
        if old_gm is not None:
            old = {"dx": ", parent %.4f" % cuda_ms(
                       torch, lambda: old_gm.grouped_mvm_bwd_dx(dy, w, rows)),
                   "dw": ", parent %.4f" % cuda_ms(
                       torch, lambda: old_gm.grouped_mvm_bwd_dw(x, dy, rows))}
        touched = int((rows > 0).sum())
        n_rows = int(rows.sum())
        flops = 2 * n_rows * D * F
        nbytes = {"dx": (n_rows * F + touched * D * F + E * C * D) * 2,
                  "dw": (n_rows * (D + F) + E * D * F) * 2}
        bounds = {kn: bound(flops, nbytes[kn]) for kn in nbytes}
        print(f"  {label} (E {E} C {C} D {D} F {F}; {touched} experts, "
              f"{n_rows} rows live): " + "  ".join(
                  f"{kn} {t[kn]:.4f} ms ({flops / t[kn] / 1e9:.0f} TFLOP/s "
                  f"over the live rows; bound {bounds[kn][0]:.4f} "
                  f"{bounds[kn][1]}{old[kn]}, plain {plain[kn]:.4f}, "
                  f"torch.bmm {lib[kn]:.4f}; relative error "
                  f"{res[kn][0]:.2e} vs plain, {res[kn][1]:.2e} vs f32 "
                  f"autograd)" for kn in t),
              flush=True)
        if not rows_out:
            rows_out = {kn: dict(ms=t[kn], plain_ms=plain[kn],
                                 bound_ms=bounds[kn][0],
                                 bound_by=bounds[kn][1], library_ms=lib[kn])
                        for kn in t}
        del x, w, dy, got, want
    free_card(torch)
    src = "src/repro_torch/kernels/csrc/grouped_mvm.cu"
    return [dict(name=f"grouped_mvm_bwd_{kn}", route="cuda", source=src,
                 replaces="src/repro/kernels/packed_mvm.py:55",
                 counter=getattr(gm, f"grouped_mvm_bwd_{kn}"),
                 max_abs_err=errs[kn], max_rel_err=rels[kn], **rows_out[kn])
            for kn in ("dx", "dw")]


# (arch, layers, steps) of (m): full width, depth cut to fit one card's
# training state (olmoe-1b-7b's 16 layers need ~111 GB; 4 hold 30.1 GB of
# f32 masters, gradients and AdamW moments), B 8 x 512 synthetic tokens
MOE_TRAIN = (("olmoe-1b-7b", 4, 10), ("deepseek-v2-lite-16b", 2, 3))
MOE_TRAIN_SEQ, MOE_TRAIN_BATCH = 512, 8


def moe_train_run(torch, train, cfg, n_steps: int):
    """``train.build_config`` on the card, then ``n_steps`` steps from seed
    0: [(loss, pre-clip gradient norm)] at full precision, and the last
    (params, opt)."""
    _, params, opt, stream, step = train.build_config(
        cfg, seq_len=MOE_TRAIN_SEQ, batch=MOE_TRAIN_BATCH, lr=3e-4,
        steps=n_steps, microbatches=1, device=DEV)
    out = []
    for i in range(n_steps):
        params, opt, m = step(params, opt, stream.batch(i))
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out, (params, opt, stream, step)


def phase_moe_train(torch, train, steps, ops, ref, L, grouped, bwd_kernels):
    """(m) MoE training on the card through ``launch.train.build_config``
    and ``make_train_step`` (remat, AdamW): olmoe-1b-7b (GQA-MoE, 64
    experts top-8) at full width cut to 4 layers, 10 steps of B 8 x 512,
    and deepseek-v2-lite-16b (MLA-MoE, top-6, 2 shared experts) cut to 2
    layers, 3 steps. Every kernel counter is zeroed just before and read
    just after: per layer and step 6 grouped forward launches (3, and 3
    again in the recomputed block), 3 dX and 3 dW, and olmoe's 2 flash
    forward and 1 of each flash backward launch, nothing else, and no
    plain version called. Every loss and gradient norm is finite and
    olmoe's loss falls; olmoe's step 1 run again from a fresh build gives
    the same loss, gradient norm and gradient digests bit for bit. Then
    one step's breakdown each (ms, tokens/s, host enqueue against device
    busy, peak memory, top kernels)."""
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import leaves

    counters = ops.launch_counters()
    counts_main = None
    for arch, n_layers, n_steps in MOE_TRAIN:
        cfg = dataclasses.replace(get_config(arch), num_layers=n_layers)
        print(f"== (m) MoE training {cfg.name} at full width, {n_layers} "
              f"layers, {n_steps} steps of B {MOE_TRAIN_BATCH} x "
              f"{MOE_TRAIN_SEQ}", flush=True)
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        calls, restore = plain_calls(ref, L)
        digests, undo = first_gradients(steps)
        t0 = time.monotonic()
        try:
            record, state = moe_train_run(torch, train, cfg, n_steps)
        finally:
            restore()
            undo()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {c.__name__: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        n_params = sum(t.numel() for t in leaves(state[0]))
        per = n_layers * n_steps
        want = {"grouped_mvm": 6 * per, "grouped_mvm_bwd_dx": 3 * per,
                "grouped_mvm_bwd_dw": 3 * per}
        if cfg.mla is None:
            want.update({"flash_attention": 2 * per,
                         **{f"flash_bwd_{n}": per
                            for n in ("rowdot", "dkdv", "dq")}})
        print(f"  {n_params / 1e9:.3f} B parameters; losses "
              f"{[round(l_, 4) for l_, _ in record]}; gradient norms "
              f"{[round(g, 3) for _, g in record]}; launches {counts}; "
              f"plain versions called {calls}; {wall:.1f} s with init; "
              f"peak memory {peak:.1f} GiB", flush=True)
        print_digests(cfg.name, digests)
        assert counts == {k: want.get(k, 0) for k in counts}, counts
        assert not any(calls.values()), calls
        assert all(math.isfinite(v) for r in record for v in r), record
        if arch == "olmoe-1b-7b":
            counts_main = counts
            assert record[-1][0] < record[0][0], record
            del state
            free_card(torch)
            again, undo = first_gradients(steps)
            try:
                rec2, state = moe_train_run(torch, train, cfg, 1)
            finally:
                undo()
            print(f"  step 1 again: loss {rec2[0][0]!r} / {record[0][0]!r}, "
                  f"gradient norm {rec2[0][1]!r} / {record[0][1]!r}; "
                  f"digests equal: {again == digests}", flush=True)
            assert rec2[0] == record[0], (rec2, record[0])
            assert again == digests, {k: (again[k], v)
                                      for k, v in digests.items()
                                      if again.get(k) != v}
        params, opt, stream, step = state
        batch = stream.batch(0)
        box = [params, opt]

        def one():
            box[0], box[1], m = step(box[0], box[1], batch)
            return m
        busy = breakdown(torch, f"train step {cfg.name} {n_layers} layers "
                         f"B={MOE_TRAIN_BATCH} S={MOE_TRAIN_SEQ}", one,
                         steps=3, part="grouped_mvm")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(3):
            m = one()
        torch.cuda.synchronize()
        ms = (time.monotonic() - t0) / 3 * 1e3
        tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
        print(f"  train step {ms:.1f} ms ({busy:.1f} ms device busy), "
              f"{tokens / ms * 1e3:.0f} tokens/s; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; loss "
              f"{float(m['loss']):.4f}", flush=True)
        del state, params, opt, box, m, batch, step
        free_card(torch)
    for k in bwd_kernels:
        del k["counter"]
        k["launches"] = counts_main[k["name"]]
        assert k["launches"] > 0, f"{k['name']} never ran on the main path"
    grouped["launches_train"] = counts_main["grouped_mvm"]


def init(torch, api, cfg):
    """Random weights of ``cfg`` from seed 0 on the card, timed."""
    t0 = time.monotonic()
    params = api.init_params(cfg, seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"== init_params {cfg.name}: {time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    return params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None,
                    help="an earlier checkout whose kernels are timed "
                         "beside this tree's")
    args = ap.parse_args(argv)
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
    from repro_torch.kernels import grouped_mvm as gm
    from repro_torch.models import get_model
    from repro_torch.models import griffin as G
    from repro_torch.models import layers as Lyr
    from repro_torch.models import moe as MoE
    from repro_torch.models import rwkv6 as R
    from repro_torch.models import transformer as T
    from repro_torch import runtime as rt
    from repro_torch import resolve_device
    from repro_torch.kernels import ref
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import pack, serve, steps, train
    from repro_torch.planner import WeightMatrix, pack_canvas

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} card {smi}", flush=True)

    t_start = t0 = time.monotonic()
    laps = [t0]

    def lap(label: str) -> None:
        """Print the seconds since the previous lap: where the script's
        own time goes."""
        now = time.monotonic()
        print(f"  [{label}: {now - laps[-1]:.1f} s]", flush=True)
        laps.append(now)
    logs = _build.build()
    print(f"== build: {sorted(logs)} in {time.monotonic() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    lap("build")
    parent = load_parent(args.parent)
    kernels = phase_kernels(torch, ops, dec, fa, parent)
    lap("(a)")

    cfg = get_config("codeqwen1.5-7b")
    params = init(torch, get_model(cfg), cfg)
    trace = engine_trace(rt, cfg)
    phase_engine(torch, T, rt, cfg, params, trace, kernels)
    lap("(b)")
    phase_breakdown(torch, T, cfg, params)
    lap("(b')")
    phase_horizon(torch, rt, ops, cfg, params, "(b'')")
    lap("(b'')")
    phase_static(torch, rt, cfg, params, trace,
                 attn=(dec.decode_attention, fa.flash_attention))
    lap("(c)")
    if parent is not None:
        phase_host_pair(torch, rt, T, cfg, params)
        lap("(c+)")
    dense_static = phase_static_mode(
        torch, serve, Lyr, ref, cfg, params,
        ["--arch", cfg.name, "--full", "--mode", "static", "--batch", "8",
         "--prompt-len", "512", "--gen", "32", "--greedy"],
        ops.launch_counters())
    lap("(j+, dense)")
    del params
    torch.cuda.empty_cache()

    resolve_device(DEV)         # full f32 matmuls in the f32 plain versions
    canvas = phase_canvas(torch, ops, ref, pack, WeightMatrix, pack_canvas,
                          get_config, parent)
    lap("(d1)")
    phase_pack(torch, pack, canvas)
    lap("(d2)")
    kernels += canvas

    grouped = phase_grouped(torch, ops, gm, parent)
    lap("(e0)")
    cfg = get_config("deepseek-v2-lite-16b")
    api = get_model(cfg)
    torch.cuda.empty_cache()
    params = init(torch, api, cfg)
    trace = engine_trace(rt, cfg)
    others = (dec.paged_decode_attention, fa.flash_attention,
              *canvas_counters())
    phase_moe_engine(torch, api, rt, cfg, params, trace, grouped, others)
    lap("(e)")
    phase_moe_breakdown(torch, MoE, cfg, params)
    lap("(e')")
    # 8 steps: an eager deepseek step enqueues thousands of kernels, each
    # of which torch.profiler records, so 32 steps are slow to profile
    phase_horizon(torch, rt, ops, cfg, params, "(e+)", h=8)
    lap("(e+)")
    phase_static(torch, rt, cfg, params, trace, "(e'')")
    lap("(e'')")
    kernels.append(grouped)
    del params
    torch.cuda.empty_cache()

    dense_dec = phase_dense_decode(torch, ops, dec, parent)
    lap("(f0)")
    counters = (dec.decode_attention, fa.flash_attention, gm.grouped_mvm,
                dec.paged_decode_attention, *canvas_counters())
    cfg = get_config("olmoe-1b-7b")
    api = get_model(cfg)
    params = init(torch, api, cfg)
    trace = engine_trace(rt, cfg)
    moe_calls = 3 * cfg.num_layers
    _, counts = phase_static_family(
        torch, rt, api, cfg, params, trace, counters,
        per_step={dec.decode_attention: cfg.num_layers,
                  gm.grouped_mvm: moe_calls},
        per_prefill={fa.flash_attention: cfg.num_layers,
                     gm.grouped_mvm: moe_calls}, label="(f)")
    dense_dec.pop("counter")
    dense_dec["launches"] = counts["decode_attention"]
    lap("(f)")
    phase_static_breakdown(torch, api, cfg, params)
    lap("(f')")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("whisper-tiny")
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device=DEV)
    trace = rt.poisson_trace(16, mean_interarrival=4.0,
                             prompt_lens=(16, 32, 48, 64),
                             gen_lens=(64, 128, 224),
                             vocab_size=cfg.vocab_size, seed=0,
                             extras_fn=rt.encdec_extras_fn(cfg))
    L, n_enc = cfg.num_layers, cfg.encoder.num_layers
    phase_static_family(
        torch, rt, api, cfg, params, trace, counters,
        per_step={dec.decode_attention: 2 * L},          # self and cross
        per_prefill={fa.flash_attention: n_enc + 2 * L}, label="(g)")
    lap("(g)")
    del params
    torch.cuda.empty_cache()

    cfg = get_config("qwen2-vl-7b")
    api = get_model(cfg)
    params = init(torch, api, cfg)
    trace = engine_trace(rt, cfg, extras_fn=rt.vlm_extras_fn(cfg))
    vlm = phase_vlm_engine(torch, rt, ops, api, cfg, params, trace)
    lap("(h)")
    phase_breakdown(torch, T, cfg, params, "(h')", extras={
        "patch_embeds": torch.randn((1, 4, cfg.d_model), device=DEV)})
    lap("(h')")
    phase_horizon(torch, rt, ops, cfg, params, "(h'')")
    lap("(h'')")
    _, static_counts = phase_static(
        torch, rt, cfg, params, trace, "(h+)", n=16,
        attn=(dec.decode_attention, fa.flash_attention))
    print(f"  qwen2-vl-7b launches: paged_decode_attention "
          f"{vlm['paged_decode_attention']} and flash_attention "
          f"{vlm['flash_attention']} in (h), decode_attention "
          f"{static_counts[0]} and flash_attention {static_counts[1]} in "
          f"(h+)", flush=True)
    lap("(h+)")
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("rwkv6-7b"), num_layers=SSM_LAYERS)
    params = init(torch, get_model(cfg), cfg)
    trace = engine_trace(rt, cfg)
    phase_ssm_engine(torch, rt, ops, R, cfg, params, trace)
    lap("(i)")
    phase_ssm_breakdown(torch, R, cfg, params)
    lap("(i')")
    # 8 steps: an eager rwkv6 step enqueues ~3,200 kernels, each of which
    # torch.profiler records, so a 32-step horizon is slow to profile
    phase_horizon(torch, rt, ops, cfg, params, "(i'')", h=8)
    lap("(i'')")
    del params
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=HYBRID_LAYERS)
    api = get_model(cfg)
    params = init(torch, api, cfg)
    hyb = phase_hybrid_engine(torch, rt, ops, api, cfg, params,
                              hybrid_trace(rt, cfg))
    lap("(j)")
    phase_hybrid_breakdown(torch, G, cfg, params)
    lap("(j')")
    # 8 steps: an eager step enqueues ~2,000 kernels, as rwkv6's (i'')
    step = phase_horizon(torch, rt, ops, cfg, params, "(j'')", h=8)
    print_hybrid_bound(torch, cfg, params, hyb, step["graphed"])
    lap("(j'')")
    del params
    torch.cuda.empty_cache()
    phase_static_entry(torch, serve, [
        "--arch", "recurrentgemma-9b", "--full", "--mode", "static",
        "--batch", "8", "--prompt-len", "512", "--gen", "32"])
    lap("(j+, hybrid)")
    print(f"  launches in the static mode (j+, dense): {dense_static}",
          flush=True)
    kernels.append(dense_dec)

    pooled = phase_pool(torch, rt, ops, ref, Lyr, T, serve, kernels)
    lap("(k)")
    phase_fleet(torch, rt, serve, *pooled)
    lap("(k')")
    del pooled
    free_card(torch)
    mesh_counts = phase_mesh(torch, serve, rt, ops, ref, Lyr, T, get_config)
    print(f"  launches in (n): paged_decode_attention "
          f"{mesh_counts['paged_decode_attention']}, flash_attention "
          f"{mesh_counts['flash_attention']}", flush=True)
    free_card(torch)
    lap("(n)")
    family_counts = phase_family_mesh(torch, serve, train, rt, ops,
                                      get_config, get_model, smi)
    print(f"  launches in (o): {family_counts}", flush=True)
    lap("(o)")
    moe_counts = phase_moe_mesh(torch, serve, rt, ops, get_config,
                                get_model, smi)
    print(f"  launches in (p): flash_attention (row 2) "
          f"{moe_counts['flash_attention']}, grouped_mvm (row 7) "
          f"{moe_counts['grouped_mvm']}, decode_attention (row 8) "
          f"{moe_counts['decode_attention']}", flush=True)
    lap("(p)")

    bwd = phase_flash_bwd(torch, fa, ref, parent)
    lap("(l0)")
    phase_train(torch, train, ckpt, ops, ref, Lyr, kernels, bwd)
    lap("(l)")
    kernels += bwd
    grouped_bwd = phase_grouped_bwd(torch, ops, gm, ref, parent)
    lap("(m0)")
    phase_moe_train(torch, train, steps, ops, ref, Lyr, grouped, grouped_bwd)
    lap("(m)")
    kernels += grouped_bwd
    print(f"all phases {time.monotonic() - t_start:.0f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          " GiB")

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
