"""Serving entry point of the port: continuous-batching engine, static
batch, model pool or fleet.

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

``--mode pool`` serves a whole model zoo (``--zoo arch[:share],..``) from
one modeled HBM budget, as the reference's pool mode does: the
``ModelPool`` bin-packs each model's weights as resident / streamed /
evicted and the ``PooledEngine`` charges weight reloads when cold models
activate (``--policy reload_aware`` or the naive ``round_robin`` swap
baseline; ``--stream layer`` streams a cold model's per-layer schedule
behind other tenants' decode, ``--stream model`` charges the whole
reload up front). The reload clock defaults to one H100's: a step is a
full-size decode step's bound at the HBM rate, reloads cross the host
link (``--reload-kib-per-step 0``). ``--repartition epoch`` moves free KV
pages between tenants every ``--epoch-steps``; ``--slab-mode bounded``
serves slab-overflow models from a 2-slice double buffer; ``--max-bypass``
caps how long a page-starved head can be bypassed; ``--shifting-mix``
reverses the zoo's traffic shares mid-trace. ``--mode fleet`` replicates
the pool ``--replicas`` times behind the demand-placement router, on one
card in one process (the replicas share the weights), with ``--chaos``
injecting replica kills, degraded DMA clocks and stragglers from a
deterministic ``FaultSchedule``. With ``--full`` the zoo's weights must
fit the card's free memory; the default five-family zoo needs 96.2 GB of
bf16 weights and does not fit one H100, so name a smaller ``--zoo``.

``--mesh host`` (the default) serves through a real 1x1 ``DeviceMesh``
(``nccl`` on the card, ``gloo`` with ``--device cpu``; the pool and the
fleet, one rank's zoo, without one); ``--mesh pod``
builds the reference's (16, 16) data x model mesh, which needs a world of
256 ranks (``torchrun``; a world of another size raises). Under a mesh of
more than one rank every family serves tensor parallel (``--mode
static|engine|auto``; the MoE family with expert-parallel experts,
head-parallel MLA and group-local dispatch over the data axes): every
rank draws the params layer by layer from ``--seed`` and keeps only its
slices (``param_pspecs``), runs the same host schedule and samples from
logits gathered over the vocabulary's split, so every rank picks the
same tokens; the static batch is split over the data axes (its caches'
KV heads expanded as ``serve_kv_expand`` says), the engine needs data
axes of one rank. Pool and fleet and a split that cuts a head raise
there. Rank 0 prints.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pool \\
      --device cpu --batch 6 --requests 18 --prompt-len 16 --gen 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode fleet \\
      --device cpu --chaos "kill@5:r0,dma@2:r1x4/20"
  PYTHONPATH=src python -m repro_torch.launch.serve --mode pool --full \\
      --zoo codeqwen1.5-7b:2,deepseek-v2-lite-16b:1,rwkv6-7b:1 --greedy \\
      --batch 8 --prompt-len 512 --gen 128
"""

from __future__ import annotations

import argparse
import json
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..models import get_model
from ..models import layers as L
from ..runtime import (Engine, EngineConfig, FaultSchedule, FleetConfig,
                       FleetEngine, ModelPool, PoolConfig, PoolEngineConfig,
                       PooledEngine, calibrated_reload_bytes_per_step,
                       diurnal_trace, encdec_extras_fn, engine_backend,
                       model_weight_bytes, multi_tenant_trace, poisson_trace,
                       shifting_mix_trace, vlm_extras_fn)
from . import sharding as sh
from .cli import add_streaming_args
from .mesh import installed, make_host_mesh, make_production_mesh

EXTRAS = {"encdec": encdec_extras_fn, "vlm": vlm_extras_fn}


def _trace(cfg, args):
    extras_fn = EXTRAS.get(cfg.family)
    return poisson_trace(
        args.requests, mean_interarrival=args.mean_interarrival,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen // 4, 1), max(args.gen // 2, 1), args.gen),
        vocab_size=cfg.vocab_size, seed=args.seed,
        extras_fn=extras_fn(cfg) if extras_fn else None)


def engine_setup(cfg, args):
    """(EngineConfig, trace) of the engine mode for the flags ``args``."""
    page = max(8, args.prompt_len // 4)
    max_len = args.prompt_len + args.gen
    pages_per_seq = -(-max_len // page) + 1
    ecfg = EngineConfig(
        num_slots=args.batch, page_size=page,
        num_pages=1 + pages_per_seq * args.batch * 2,
        max_pages_per_seq=pages_per_seq, prefill_bucket=page,
        greedy=args.greedy, temperature=args.temperature, seed=args.seed)
    return ecfg, _trace(cfg, args)


def run_engine(cfg, params, args):
    """Continuous batching against a Poisson arrival trace."""
    ecfg, trace = engine_setup(cfg, args)
    rep = Engine(cfg, params, ecfg).run(trace)
    done = [r for r in rep.completed if not r.truncated]
    if _rank0():
        print(f"arch={cfg.name} mode=engine slots={args.batch} "
              f"requests={args.requests}")
        print(json.dumps(rep.summary(), indent=1))
        for r in done[:2]:
            print(f"  req{r.rid}: {r.generated}")
    assert done, "no requests completed"
    if _rank0():
        print("ok")
    return 0


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def run_static_mode(cfg, params, args, mesh=None):
    """The reference's lockstep path: one prefill, ``--gen`` decode steps
    in unison (``static_decode``), its times and tokens printed.
    (``runtime.run_static`` is the engine's baseline on a trace; this is
    the entry point's fixed batch.)"""
    out, t_prefill, t_decode = static_decode(cfg, params, args, mesh)
    if _rank0():
        print(f"arch={cfg.name} mode=static batch={args.batch} "
              f"prompt={args.prompt_len} gen={args.gen}")
        print(f"prefill: {t_prefill * 1e3:.1f} ms   "
              f"decode: {t_decode * 1e3:.1f} ms/token")
        for b in range(min(args.batch, 2)):
            print(f"  seq{b}: {out[b].tolist()}")
        print("ok")
    return 0


def static_decode(cfg, params, args, mesh=None):
    """The static mode's tokens (batch, ``--gen``) as numpy, the prefill's
    seconds and the seconds a decode step. Under a mesh every rank draws
    the whole batch and keeps its rows (the batch spec's split over the
    data axes); the sampler reads the logits over the whole vocabulary
    (``layers.whole_vocab``), gathered over the data axes, and draws for
    the whole batch, so every rank picks the tokens of one rank."""
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
    rows = sh.P(sh.batch_dim_spec(B, mesh)) if mesh else sh.P(None)
    batch = {k: sh.local_slice(v, rows, mesh) for k, v in batch.items()}

    def sample(logits):
        logits = L.dp_all_gather(L.whole_vocab(logits, cfg.vocab_size), 0)
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
    logits, state = api.prefill(cfg, params, batch, cache_len,
                                kv_expand=L.serve_kv_expand(cfg,
                                                            L.tp_size()))
    sync()
    t_prefill = time.monotonic() - t0

    toks = []
    tok = sample(logits)
    t0 = time.monotonic()
    for _ in range(args.gen):
        toks.append(tok)
        logits, state = api.decode_step(cfg, params, state,
                                        sh.local_slice(tok, rows, mesh))
        tok = sample(logits)
    sync()
    t_decode = (time.monotonic() - t0) / args.gen

    assert torch.isfinite(logits).all()
    return torch.stack(toks, dim=1).cpu().numpy(), t_prefill, t_decode


def parse_zoo(spec: str) -> list[tuple[str, float]]:
    """``arch[:share],arch[:share],..`` -> [(arch_id, traffic share)]."""
    out = []
    for item in spec.split(","):
        arch, _, share = item.strip().partition(":")
        out.append((arch, float(share) if share else 1.0))
    return out


def _pool_engine_config(args) -> PoolEngineConfig:
    """The reference's pool/fleet engine settings for the flags."""
    page = max(8, args.prompt_len // 4)
    max_len = args.prompt_len + args.gen
    pages_per_seq = -(-max_len // page) + 1
    return PoolEngineConfig(
        num_slots=args.batch, page_size=page,
        num_pages=1 + pages_per_seq * args.batch * 2,
        max_pages_per_seq=pages_per_seq, prefill_bucket=page,
        greedy=args.greedy, temperature=args.temperature, seed=args.seed,
        policy=args.policy, rr_quantum=args.rr_quantum,
        stream=args.stream, repartition=args.repartition,
        epoch_steps=args.epoch_steps,
        max_bypass_steps=args.max_bypass)


def _zoo_trace(trace_fn, tenants, args):
    return trace_fn(
        tenants, args.requests, mean_interarrival=args.mean_interarrival,
        prompt_lens=(max(args.prompt_len // 2, 1), args.prompt_len),
        gen_lens=(max(args.gen // 4, 1), max(args.gen // 2, 1), args.gen),
        seed=args.seed)


def zoo_configs(args):
    """The zoo of ``--zoo``: [(arch, share)], configs (``--full``: the
    published widths, else reduced) and the trace's tenant specs."""
    zoo = parse_zoo(args.zoo)
    cfgs, tenants = {}, []
    for arch, share in zoo:
        cfg = get_config(arch) if args.full else get_config(arch).reduced()
        cfgs[arch] = cfg
        tenants.append(dict(
            model_id=arch, vocab_size=cfg.vocab_size, share=share,
            extras_fn=vlm_extras_fn(cfg) if cfg.family == "vlm" else None))
    return zoo, cfgs, tenants


def zoo_params(cfgs: dict, args) -> dict:
    """Random weights for every zoo model from ``--seed`` on ``--device``.
    On the card the zoo's weight bytes are checked against the free
    device memory first: a zoo that cannot fit raises before anything is
    allocated."""
    need = sum(model_weight_bytes(c) for c in cfgs.values())
    if args.device == "cuda" and torch.cuda.is_available():
        free, total = torch.cuda.mem_get_info()
        if need > free:
            raise RuntimeError(
                f"zoo {args.zoo!r} needs {need / 1e9:.2f} GB of bf16 "
                f"weights, but the card has {free / 1e9:.2f} GB free (of "
                f"{total / 1e9:.2f} GB); serve a smaller --zoo")
    return {arch: get_model(cfg).init_params(cfg, args.seed,
                                              device=args.device)
            for arch, cfg in cfgs.items()}


def pool_config(cfgs: dict, args) -> PoolConfig:
    """The reference's auto-sized PoolConfig for the zoo: the budget pins
    ~62% of the zoo with a slab big enough for the largest working set
    (``--hbm-budget-kib`` 0), and the H100-calibrated reload clock
    (``--reload-kib-per-step`` 0), printed."""
    weights = {a: model_weight_bytes(c) for a, c in cfgs.items()}
    s = args.slab_frac
    if not 0.0 < s < 1.0:
        raise SystemExit("--slab-frac must be in (0, 1)")
    budget = args.hbm_budget_kib * 1024 or 1024 + int(max(
        0.62 * sum(weights.values()) / (1.0 - s),
        max(weights.values()) / s))
    reload_bps, label = args.reload_kib_per_step * 1024, ""
    if not reload_bps:
        reload_bps = calibrated_reload_bytes_per_step(cfgs.items())
        label = " (H100-calibrated: decode-step bound at the HBM rate, " \
            "reloads over the host link)"
    print(f"reload clock: {reload_bps} B/step{label}")
    return PoolConfig(hbm_budget_bytes=budget, slab_frac=s,
                      reload_bytes_per_step=reload_bps,
                      hysteresis_steps=args.hysteresis,
                      slab_mode=args.slab_mode, quant=args.quant)


def zoo_setup(args, params: dict | None = None):
    """Shared pool/fleet construction: the zoo, its configs, params (the
    caller's ``params`` where given, else random from ``--seed``), the
    trace's tenants and the auto-sized PoolConfig."""
    zoo, cfgs, tenants = zoo_configs(args)
    if params is None:
        params = zoo_params(cfgs, args)
    return zoo, cfgs, params, tenants, pool_config(cfgs, args)


def run_pool(args, params: dict | None = None):
    """Multi-tenant serving: a model zoo bin-packed into one HBM pool."""
    zoo, cfgs, params, tenants, pcfg = zoo_setup(args, params)
    pool = ModelPool(pcfg)
    for arch, share in zoo:
        pool.register(arch, cfgs[arch], demand=share)
    plan = pool.pack()
    print(json.dumps(plan.summary(), indent=1))
    trace = _zoo_trace(shifting_mix_trace if args.shifting_mix
                       else multi_tenant_trace, tenants, args)
    eng = PooledEngine(pool, params, _pool_engine_config(args))
    rep = eng.run(trace)
    print(f"zoo={args.zoo} mode=pool policy={args.policy} "
          f"stream={args.stream} slab_mode={args.slab_mode} "
          f"repartition={args.repartition} slots={args.batch} "
          f"requests={args.requests}")
    print(json.dumps(rep.summary(), indent=1))
    print(json.dumps({"arena": eng.arena.summary()}, indent=1))
    done = [r for r in rep.completed if not r.truncated]
    for r in done[:3]:
        print(f"  req{r.rid} [{r.model_id}]: {r.generated}")
    assert done, "no requests completed"
    print("ok")
    return 0


def run_fleet(args, params: dict | None = None):
    """Replicated pools behind the demand-placement router, with
    optional chaos injection (``--chaos "kill@120:r1,dma@200:r0x4/100"``);
    the replicas share ``params``."""
    zoo, cfgs, params, tenants, pcfg = zoo_setup(args, params)
    fcfg = FleetConfig(n_replicas=args.replicas, placement=args.placement)
    faults = FaultSchedule.parse(args.chaos) if args.chaos else None
    trace = _zoo_trace(diurnal_trace, tenants, args)
    fleet = FleetEngine([(a, cfgs[a], share) for a, share in zoo],
                        pcfg, _pool_engine_config(args), params, fcfg,
                        faults=faults)
    rep = fleet.run(trace)
    print(f"zoo={args.zoo} mode=fleet replicas={args.replicas} "
          f"placement={args.placement} chaos={args.chaos or 'none'} "
          f"requests={args.requests}")
    print(json.dumps(rep.summary(), indent=1))
    assert rep.requests_lost == 0
    assert rep.completed, "no requests completed"
    print("ok")
    return 0


def parse_args(argv=None) -> argparse.Namespace:
    """The entry point's flags (``--requests`` 0 becomes 3 x ``--batch``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen1.5-7b")
    ap.add_argument("--full", action="store_true",
                    help="published width (default: the reduced config)")
    ap.add_argument("--mesh", default="host", choices=("host", "pod"),
                    help="host: the 1x1 mesh on one device; pod: the "
                         "reference's (16, 16) data x model mesh, 256 "
                         "ranks under torchrun")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "engine", "static", "pool", "fleet"),
                    help="auto: the engine where the config has a backend, "
                         "else static; pool / fleet serve --zoo")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet mode: number of replicated pools")
    ap.add_argument("--placement", default="demand",
                    choices=("demand", "mirror"),
                    help="fleet model placement: 'demand' packs copies "
                         "by reuse-per-byte, 'mirror' puts every model "
                         "on every replica that fits (static baseline)")
    ap.add_argument("--chaos", default="",
                    help="fleet fault schedule, e.g. "
                         "'kill@120:r1,dma@200:r0x4/100,straggle@300:r2x3/50'")
    ap.add_argument("--zoo",
                    default="codeqwen1.5-7b:2,qwen2-vl-7b:1,rwkv6-7b:1,"
                            "recurrentgemma-9b:1,deepseek-v2-lite-16b:1",
                    help="pool mode model-zoo spec: arch[:share],..")
    ap.add_argument("--policy", default="reload_aware",
                    choices=("reload_aware", "round_robin"))
    add_streaming_args(ap)          # --stream/--slab-mode/--reload-kib/--quant
    ap.add_argument("--repartition", default="off",
                    choices=("off", "epoch"),
                    help="KV page leases: 'off' freezes the init-time "
                         "partition, 'epoch' follows per-tenant "
                         "live-page watermarks every --epoch-steps")
    ap.add_argument("--epoch-steps", type=int, default=64,
                    help="steps between arena repartition epochs")
    ap.add_argument("--max-bypass", type=int, default=64,
                    help="admission aging bound: max steps a page-"
                         "starved head can be bypassed (0 = unbounded)")
    ap.add_argument("--shifting-mix", action="store_true",
                    help="reverse the zoo's traffic shares mid-trace "
                         "(the repartition stress shape)")
    ap.add_argument("--hbm-budget-kib", type=int, default=0,
                    help="pool HBM budget (0 -> auto-size from the zoo)")
    ap.add_argument("--slab-frac", type=float, default=0.5,
                    help="pool budget fraction reserved for weight swaps")
    ap.add_argument("--hysteresis", type=int, default=32,
                    help="min steps a model stays hot before eviction")
    ap.add_argument("--rr-quantum", type=int, default=16,
                    help="round_robin steps per tenant turn")
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


def init_params(cfg, args, mesh=None):
    """Random weights from ``--seed`` on ``--device``; under a mesh of
    more than one rank only this rank's slices of the params
    (``param_pspecs``), drawn one matrix or layer at a time: no rank
    holds the whole model, and each slice equals the one-rank draw's."""
    api = get_model(cfg)
    if mesh is None or mesh.size == 1:
        return api.init_params(cfg, args.seed, device=args.device)
    specs = sh.param_pspecs(api.init_params(cfg, device="meta"), mesh)
    return api.init_params(cfg, args.seed, device=args.device,
                           local=sh.local_init(specs, mesh))


def make_serving_mesh(args):
    """``--mesh``: the 1x1 host mesh, or the reference's (16, 16) pod,
    which raises in a world of another size than 256."""
    if args.mesh == "host":
        return make_host_mesh(args.device)
    return make_production_mesh(device=args.device)


def main(argv=None):
    args = parse_args(argv)
    if args.mode in ("pool", "fleet") and args.mesh == "host":
        # a zoo is one rank's: it serves without a mesh, its bytes held
        # against the card's free memory before anything is allocated
        return run_pool(args) if args.mode == "pool" else run_fleet(args)
    mesh = make_serving_mesh(args)
    try:
        with installed(mesh):
            return serve(args, mesh)
    finally:
        mesh.close()


def serve(args, mesh):
    """Serve ``args`` on ``mesh`` (installed)."""
    if args.mode in ("pool", "fleet"):
        if mesh.size > 1:
            raise NotImplementedError(
                f"--mode {args.mode} under a mesh of {mesh.size} ranks: the "
                f"pool and the fleet are sharded in a later slice of the "
                f"mesh port (ROADMAP, Queue 1, item 2.3)")
        return run_pool(args) if args.mode == "pool" else run_fleet(args)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    mode = args.mode
    if mode == "auto":
        mode = "engine" if engine_backend(cfg) else "static"
    params = init_params(cfg, args, mesh)
    if mode == "engine":
        return run_engine(cfg, params, args)
    return run_static_mode(cfg, params, args, mesh)


if __name__ == "__main__":
    raise SystemExit(main())
