"""HBM weight-residency planner — the paper's D_m capacity story at pod scale.

Copy of ``repro.planner.residency`` for the port (pure Python; the port
imports nothing of the JAX package). ``model_pool`` packs a zoo with it
and streams each model's ``layer_schedule``.

An IMC macro keeps weights stationary; spilling to DRAM costs reload energy
and stall latency. On a TPU pod the same economics appear one level up:

    resident  = parameter sharded over the model (TP) axis only, replicated
                across data — zero per-step weight traffic (stationary);
    streamed  = additionally sharded over the data axis (FSDP/ZeRO-3) and
                all-gathered every step — the TPU form of weight reloading.

Given an arch config and a mesh, the planner bin-packs parameter tensors
into the per-chip HBM budget, spilling to *streamed* in ascending order of
**compute reuse per parameter** — the transplant of the paper's fold-the-
lowest-latency-layer-first heuristic (§3.4): tensors with the least MACs
per byte (embeddings ~0, MoE experts k/E, dense matmuls 1) lose the least
from streaming.

Optimizer state (f32 master + Adam m/v) is always ZeRO-sharded over
(data x model); the resident/streamed decision concerns the bf16/f32
compute copy of each parameter.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

GiB = 1 << 30

# --- compressed streaming: per-slice precision + quantized byte accounting -----

#: streaming quantization modes (the CLI surface): ``off`` streams the
#: bf16 serving copy verbatim; ``int8``/``int4`` quantize every streamed
#: slice; ``auto`` picks per layer by the sensitivity/byte-savings policy
#: (``stream_precisions``).
QUANT_MODES = ("off", "int8", "int4", "auto")

#: params covered by one per-channel scale group — matches the kernel's
#: per-output-channel scales on 128x128 MXU blocks (kernels.dequant).
SCALE_GROUP = 128
SCALE_BYTES = 2                         # bf16 scales

_QUANT_BITS = {"int8": 8, "int4": 4}


def quant_bytes(fp_nbytes: int, precision: str, param_bytes: int = 2) -> int:
    """Stored bytes of ``fp_nbytes`` of bf16 weights re-encoded at
    ``precision``: the integer payload plus one bf16 scale per
    ``SCALE_GROUP`` params (the kernel's per-channel block scales).

    ``"fp"`` is the identity. int8 lands at ~1.97x smaller, int4 at
    ~3.9x — the scale overhead is 1/64 of the fp bytes either way.
    """
    if precision == "fp" or fp_nbytes == 0:
        return fp_nbytes
    bits = _QUANT_BITS[precision]
    payload = -(-fp_nbytes * bits // (8 * param_bytes))
    scales = SCALE_BYTES * -(-fp_nbytes // (param_bytes * SCALE_GROUP))
    return payload + scales


def stream_precisions(names, quant: str) -> tuple[str, ...]:
    """Per-slice streaming precision for a ``layer_schedule`` slice-name
    sequence — LRMP's per-layer mixed precision, chosen by a simple
    sensitivity/byte-savings rule instead of a calibration run:

      * ``off``            -> everything ``fp``;
      * ``int8``/``int4``  -> every slice at that precision;
      * ``auto``           -> the quality-sensitive boundary slices
        (embed table, lm head, first and last decode layer: the ends of
        the network where quantization error has no depth to wash out)
        keep int8, everything interior — including routed expert slices,
        whose reuse per byte is the lowest in the model — drops to int4.
    """
    assert quant in QUANT_MODES, quant
    names = list(names)
    if quant == "off":
        return tuple("fp" for _ in names)
    if quant in _QUANT_BITS:
        return tuple(quant for _ in names)
    layers = sorted({n.split("/")[0] for n in names
                     if n.startswith("layer")})
    sensitive = {"embed", "head"}
    if layers:
        sensitive |= {layers[0], layers[-1]}
    return tuple("int8" if n in sensitive else "int4" for n in names)


@dataclasses.dataclass(frozen=True)
class ParamTensor:
    """One shardable parameter tensor (stacked over layers where applicable).

    reuse = MACs per parameter per processed token (the stationarity value
    of keeping it resident). tp_shardable: can it shard over the model axis.
    """
    name: str
    params: int
    reuse: float
    tp_shardable: bool = True


def weight_inventory(cfg) -> list[ParamTensor]:
    """Flatten a ModelConfig into shardable parameter tensors."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    out = [ParamTensor("embed", V * D, reuse=0.0)]
    if cfg.family == "ssm":                      # rwkv6
        out += [ParamTensor("att_proj", L * 4 * D * D, 1.0),
                ParamTensor("mixers", L * 10 * D * 64, 1.0),
                ParamTensor("ffn", L * 2 * D * F, 1.0)]
    elif cfg.family == "hybrid":                 # griffin/recurrentgemma
        pat = cfg.recurrent.block_pattern
        n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "attn")
        n_rec = L - n_attn
        W = cfg.recurrent.lru_width or D
        out += [ParamTensor("attn", n_attn * (D * cfg.q_dim
                                              + 2 * D * cfg.kv_dim
                                              + cfg.q_dim * D), 1.0),
                ParamTensor("recurrent", n_rec * (2 * D * W + W * D), 1.0),
                ParamTensor("ffn", L * 3 * D * F, 1.0)]
    else:
        if cfg.mla is not None:
            m = cfg.mla
            att = (D * cfg.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                   + D * (m.kv_lora_rank + m.qk_rope_head_dim)
                   + m.kv_lora_rank * cfg.num_heads
                   * (m.qk_nope_head_dim + m.v_head_dim)
                   + cfg.num_heads * m.v_head_dim * D)
        else:
            att = D * cfg.q_dim + 2 * D * cfg.kv_dim + cfg.q_dim * D
        out.append(ParamTensor("attn", L * att, 1.0))
        if cfg.moe:
            mo = cfg.moe
            out.append(ParamTensor(
                "experts", L * mo.num_experts * 3 * D * mo.d_ff_expert,
                reuse=mo.top_k / mo.num_experts))
            if mo.num_shared_experts:
                out.append(ParamTensor(
                    "shared_experts",
                    L * mo.num_shared_experts * 3 * D * mo.d_ff_expert, 1.0))
            out.append(ParamTensor("router", L * D * mo.num_experts, 1.0))
        else:
            out.append(ParamTensor("ffn", L * 3 * D * F, 1.0))
    if cfg.encoder is not None and cfg.family == "encdec":
        E = cfg.encoder.num_layers
        out += [ParamTensor("encoder", E * (4 * D * D + 2 * D * F), 1.0),
                ParamTensor("cross_attn", L * 4 * D * D, 1.0)]
    if not cfg.tie_embeddings:
        out.append(ParamTensor("lm_head", D * V, 1.0))
    out.append(ParamTensor("norms", L * 2 * D + D, 1.0,
                           tp_shardable=False))
    return out


@dataclasses.dataclass(frozen=True)
class LayerSlice:
    """One forward-order slice of a model's serving weight copy — the unit
    of layer-granular streaming (fetch slice k+1 while slice k computes,
    the paper's folded-tile pipelining at serving scale).

    ``nbytes`` is always the bf16 (fp) size; ``precision`` is the
    encoding the slice travels over DMA in, and ``stream_nbytes`` the
    bytes that encoding actually moves (``quant_bytes``)."""
    name: str
    nbytes: int
    precision: str = "fp"

    def stream_nbytes(self, param_bytes: int = 2) -> int:
        return quant_bytes(self.nbytes, self.precision, param_bytes)


def layer_schedule(cfg, param_bytes: int = 2,
                   include: frozenset[str] | set[str] | None = None,
                   quant: str = "off",
                   ) -> tuple[LayerSlice, ...]:
    """Ordered per-layer byte schedule of the serving weight copy.

    The schedule has a leading ``embed`` slice (embedding table, plus the
    encoder stack for enc-dec models: both are consumed before the first
    decode layer), one slice per decode layer (every layer-stacked tensor
    split evenly, remainder bytes spread over the leading layers so
    totals conserve exactly), and a trailing ``head`` slice (untied
    lm_head) — ``2 + cfg.num_layers`` slices for dense families.

    MoE models additionally split the routed ``experts`` tensor into
    PER-EXPERT slices (``layerNN/expEE`` after each layer's core slice,
    ``2 + num_layers * (1 + num_experts)`` total): a cold expert is its
    own streaming unit, so the pool can prefetch experts behind decode
    exactly like any other layer slice instead of moving the whole
    expert block as one stall.

    ``include`` restricts the schedule to a subset of
    ``weight_inventory`` tensor names while keeping the slice structure
    aligned, so a pinned-tensor subset can be subtracted slice-by-slice
    from the full schedule.

    ``quant`` stamps each slice with its streaming precision via
    ``stream_precisions``; slice ``nbytes`` stay fp so byte conservation
    against ``weight_inventory`` and include-subset alignment hold
    regardless of mode — quantized sizes live in ``stream_nbytes``.
    """
    inv = weight_inventory(cfg)
    if include is not None:
        inv = [t for t in inv if t.name in include]
    L = cfg.num_layers
    experts = cfg.moe.num_experts if cfg.moe else 0
    lead = tail = per_layer = expert_bytes = 0
    for t in inv:
        b = param_bytes * t.params
        if t.name in ("embed", "encoder"):
            lead += b
        elif t.name == "lm_head":
            tail += b
        elif t.name == "experts" and experts:
            expert_bytes += b
        else:
            per_layer += b
    base, rem = divmod(per_layer, L)
    slices = [LayerSlice("embed", lead)]
    if experts:
        ebase, erem = divmod(expert_bytes, L * experts)
        for i in range(L):
            slices.append(
                LayerSlice(f"layer{i:02d}", base + (1 if i < rem else 0)))
            for x in range(experts):
                idx = i * experts + x
                slices.append(LayerSlice(
                    f"layer{i:02d}/exp{x:02d}",
                    ebase + (1 if idx < erem else 0)))
    else:
        slices += [LayerSlice(f"layer{i:02d}",
                              base + (1 if i < rem else 0))
                   for i in range(L)]
    slices.append(LayerSlice("head", tail))
    precs = stream_precisions((s.name for s in slices), quant)
    return tuple(dataclasses.replace(s, precision=p)
                 for s, p in zip(slices, precs))


def double_buffer_bytes(schedule) -> int:
    """Slice-pair granularity of a streaming schedule: the bytes a
    2-slice double buffer must hold to pipeline it — the max over the
    forward walk of two ADJACENT slices resident at once (slice k
    computing out of one buffer while slice k+1 streams into the other).
    This is the bounded streaming slab's working set: instead of the
    whole reload set, only the worst adjacent pair is ever resident.

    ``schedule`` is an iterable of per-slice byte counts in forward
    order (e.g. ``ModelEntry.reload_schedule``)."""
    sizes = [int(b) for b in schedule]
    if not sizes:
        return 0
    if len(sizes) == 1:
        return sizes[0]
    return max(a + b for a, b in zip(sizes, sizes[1:]))


@dataclasses.dataclass(frozen=True)
class Decision:
    tensor: ParamTensor
    mode: str                       # "resident" | "streamed"
    bytes_per_chip: int             # steady-state HBM held by this tensor
    stream_bytes_per_step: int      # per-chip all-gather receive bytes


@dataclasses.dataclass(frozen=True)
class ResidencyPlan:
    decisions: tuple[Decision, ...]
    tp: int
    dp: int
    train: bool
    hbm_budget_bytes: int

    @property
    def bytes_per_chip(self) -> int:
        return sum(d.bytes_per_chip for d in self.decisions)

    @property
    def stream_bytes_per_step(self) -> int:
        return sum(d.stream_bytes_per_step for d in self.decisions)

    @property
    def fits(self) -> bool:
        return self.bytes_per_chip <= self.hbm_budget_bytes

    @property
    def streamed(self) -> frozenset[str]:
        return frozenset(d.tensor.name for d in self.decisions
                         if d.mode == "streamed")

    def summary(self) -> dict:
        return {
            "tp": self.tp, "dp": self.dp, "train": self.train,
            "GiB_per_chip": round(self.bytes_per_chip / GiB, 3),
            "budget_GiB": round(self.hbm_budget_bytes / GiB, 3),
            "fits": self.fits,
            "streamed": sorted(self.streamed),
            "stream_MiB_per_step":
                round(self.stream_bytes_per_step / (1 << 20), 2),
        }


def _tensor_bytes(t: ParamTensor, tp: int, dp: int, *, train: bool,
                  streamed: bool, param_bytes: int = 2) -> tuple[int, int]:
    """(steady bytes/chip, stream bytes/step/chip) for one tensor."""
    shard_tp = tp if t.tp_shardable else 1
    opt = 12 * t.params // (tp * dp) if train else 0   # ZeRO: f32 master+m+v
    if streamed:
        held = param_bytes * t.params // (shard_tp * dp)
        gathered = param_bytes * t.params // shard_tp
        traffic = gathered - held                       # all-gather receive
        if train:
            traffic *= 2                                # + reduce-scatter grads
        return held + opt, traffic
    return param_bytes * t.params // shard_tp + opt, 0


def plan_residency(cfg, *, tp: int, dp: int, train: bool,
                   hbm_gb: float = 16.0, reserve_frac: float = 0.35,
                   param_bytes: int = 2) -> ResidencyPlan:
    """Pack tensors into HBM; spill lowest-reuse-per-byte first.

    reserve_frac of HBM is withheld for activations, KV caches and
    collective scratch. param_bytes=2: bf16 compute copies.
    """
    budget = int(hbm_gb * GiB * (1.0 - reserve_frac))
    tensors = weight_inventory(cfg)
    # paper §3.4 heuristic, transplanted: spill candidates ordered by
    # ascending reuse (MACs/param), then descending size.
    spill_order = sorted(tensors, key=lambda t: (t.reuse, -t.params))
    streamed: set[str] = set()

    def total(streamed_names: set[str]) -> int:
        return sum(_tensor_bytes(t, tp, dp, train=train,
                                 streamed=t.name in streamed_names,
                                 param_bytes=param_bytes)[0]
                   for t in tensors)

    for t in spill_order:
        if total(streamed) <= budget:
            break
        if dp > 1:
            streamed.add(t.name)

    decisions = []
    for t in tensors:
        s = t.name in streamed
        held, traffic = _tensor_bytes(t, tp, dp, train=train, streamed=s,
                                      param_bytes=param_bytes)
        decisions.append(Decision(t, "streamed" if s else "resident",
                                  held, traffic))
    return ResidencyPlan(tuple(decisions), tp, dp, train, budget)
