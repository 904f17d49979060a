"""Serving entry point of the port: continuous-batching engine or static batch.

``--mode engine`` runs the Engine (admission queue, per-slot request
state, paged KV cache, slot recycling) against a mixed-length Poisson
arrival trace. ``--mode static`` is the reference's lockstep path: one
batch of ``--batch`` random prompts of ``--prompt-len`` tokens (with
random frames for the encoder-decoder family and patch embeddings for
vlm, all drawn from one ``torch.Generator`` seeded with ``--seed``)
prefills once into a cache of ``--cache-len`` tokens (default prompt +
gen), then decodes ``--gen`` steps in unison with temperature sampling
(``--greedy``: argmax), and prints the prefill ms and the decode ms a
token. ``--mode auto`` (the default, as in the reference) takes the
engine where ``engine_backend`` finds a backend for the config and the
static path otherwise. Weights are random (``init_params`` from
``--seed``). ``--full`` serves the published width of ``--arch``;
without it, the reduced config. The dense archs (codeqwen1.5-7b,
olmo-1b) and qwen2-vl-7b (vlm) serve through the paged-KV backend,
deepseek-v2-lite-16b (MLA-MoE) through the latent-page backend,
rwkv6-7b (ssm) through the recurrent backend (a constant state per
slot, no pages), recurrentgemma-9b (hybrid) through the hybrid backend
(a recurrent state per slot and a window ring of pages). olmoe-1b-7b
(GQA-MoE) and whisper-tiny (encoder-decoder) have no engine backend, as
in the reference, so ``auto`` serves them static (``--mode engine``
raises). In the engine, qwen2-vl's requests carry random patch
embeddings and whisper's random frame embeddings, drawn from the trace's
rng. The engine sizes its page tables from prompt + gen, as the
reference does, so ``--full --arch recurrentgemma-9b --mode engine``
raises in both packages whenever prompt + gen is shorter than the
2,048-token window (too few rows for the window's ring). The run
is on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch codeqwen1.5-7b \\
      --full
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v2-lite-16b --full --greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
      --full --greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --full --greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-vl-7b \\
      --full --greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --full --greedy
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-9b --full --mode static --batch 8 \\
      --prompt-len 512 --gen 32
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..configs import get_config
from ..models import get_model
from ..runtime import (Engine, EngineConfig, encdec_extras_fn, engine_backend,
                       poisson_trace, vlm_extras_fn)

EXTRAS = {"encdec": encdec_extras_fn, "vlm": vlm_extras_fn}


def _trace(cfg, args):
    extras_fn = EXTRAS.get(cfg.family)
    return poisson_trace(
        args.requests, mean_interarrival=args.mean_interarrival,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen // 4, 1), max(args.gen // 2, 1), args.gen),
        vocab_size=cfg.vocab_size, seed=args.seed,
        extras_fn=extras_fn(cfg) if extras_fn else None)


def run_engine(cfg, params, args):
    """Continuous batching against a Poisson arrival trace."""
    page = max(8, args.prompt_len // 4)
    max_len = args.prompt_len + args.gen
    pages_per_seq = -(-max_len // page) + 1
    ecfg = EngineConfig(
        num_slots=args.batch, page_size=page,
        num_pages=1 + pages_per_seq * args.batch * 2,
        max_pages_per_seq=pages_per_seq, prefill_bucket=page,
        greedy=args.greedy, temperature=args.temperature, seed=args.seed)
    rep = Engine(cfg, params, ecfg).run(_trace(cfg, args))
    print(f"arch={cfg.name} mode=engine slots={args.batch} "
          f"requests={args.requests}")
    print(json.dumps(rep.summary(), indent=1))
    done = [r for r in rep.completed if not r.truncated]
    for r in done[:2]:
        print(f"  req{r.rid}: {r.generated}")
    assert done, "no requests completed"
    print("ok")
    return 0


def run_static_mode(cfg, params, args):
    """The reference's lockstep path: one prefill, ``--gen`` decode steps
    in unison. (``runtime.run_static`` is the engine's baseline on a
    trace; this is the entry point's fixed batch.)"""
    api = get_model(cfg)
    dev = params["embed"].device
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cache_len = args.cache_len or (args.prompt_len + args.gen)
    B = args.batch
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (B, args.prompt_len), generator=gen, device=dev,
        dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((B, cfg.encoder.seq_len, cfg.d_model),
                                      generator=gen, device=dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.randn((B, 4, cfg.d_model),
                                            generator=gen, device=dev)

    def sample(logits):
        if args.greedy:
            return logits.argmax(-1).to(torch.int32)
        probs = torch.softmax(logits / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.monotonic()
    logits, state = api.prefill(cfg, params, batch, cache_len)
    sync()
    t_prefill = time.monotonic() - t0

    toks = []
    tok = sample(logits)
    t0 = time.monotonic()
    for _ in range(args.gen):
        toks.append(tok)
        logits, state = api.decode_step(cfg, params, state, tok)
        tok = sample(logits)
    sync()
    t_decode = (time.monotonic() - t0) / args.gen

    out = torch.stack(toks, dim=1).cpu().numpy()
    print(f"arch={cfg.name} mode=static batch={B} "
          f"prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms   "
          f"decode: {t_decode * 1e3:.1f} ms/token")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {out[b].tolist()}")
    assert torch.isfinite(logits).all()
    print("ok")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    """The entry point's flags (``--requests`` 0 becomes 3 x ``--batch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--full", action="store_true",
                    help="published width (default: the reduced config)")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "engine", "static"),
                    help="auto: the engine where the config has a backend, "
                         "else static")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--batch", type=int, default=4,
                    help="static batch size / engine slot count")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=0,
                    help="static cache length (default prompt + gen)")
    ap.add_argument("--requests", type=int, default=0,
                    help="engine trace length (default 3x slots)")
    ap.add_argument("--mean-interarrival", type=float, default=0.5,
                    help="engine trace mean gap in decode steps")
    ap.add_argument("--greedy", action="store_true",
                    help="greedy sampling (the engine's fused horizons on "
                         "the device; argmax in static mode); default: "
                         "temperature sampling per step")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not args.requests:
        args.requests = 3 * args.batch
    return args


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    mode = args.mode
    if mode == "auto":
        mode = "engine" if engine_backend(cfg) else "static"
    params = get_model(cfg).init_params(cfg, args.seed, device=args.device)
    if mode == "engine":
        return run_engine(cfg, params, args)
    return run_static_mode(cfg, params, args)


if __name__ == "__main__":
    raise SystemExit(main())
