"""Workload definitions.

MLPerf Tiny [2] — the paper's benchmark suite (§4):
  * ResNet-8        image classification, CIFAR-10 32x32x3
  * DS-CNN          keyword spotting, 49x10 MFCC input
  * MobileNetV1-.25 visual wake words, 96x96x3
  * AutoEncoder     anomaly detection, FC 640->128->...->8->...->640

Layer shapes follow the MLPerf Tiny reference models (mlcommons/tiny).

Additionally, `lm_workload` flattens any of the assigned LM architecture
configs (src/repro/configs) into a LayerSpec sequence so the same packer /
cost model can map transformer blocks onto IMC fabrics — and so the TPU
residency planner can bin-pack LM weights into HBM budgets.
"""

from __future__ import annotations

from .loops import LayerSpec, Workload

conv = LayerSpec.conv2d
fc = LayerSpec.fc


def resnet8() -> Workload:
    """MLPerf Tiny image classification (ResNet-8 v1, CIFAR-10)."""
    L = []
    L.append(conv("conv_in", 3, 16, 3, (32, 32)))
    # stack 1: 16ch, 32x32
    L.append(conv("s1_c1", 16, 16, 3, (32, 32)))
    L.append(conv("s1_c2", 16, 16, 3, (32, 32)))
    # stack 2: 32ch, stride 2 -> 16x16 (+1x1 shortcut)
    L.append(conv("s2_c1", 16, 32, 3, (16, 16)))
    L.append(conv("s2_c2", 32, 32, 3, (16, 16)))
    L.append(conv("s2_sc", 16, 32, 1, (16, 16)))
    # stack 3: 64ch, stride 2 -> 8x8 (+1x1 shortcut)
    L.append(conv("s3_c1", 32, 64, 3, (8, 8)))
    L.append(conv("s3_c2", 64, 64, 3, (8, 8)))
    L.append(conv("s3_sc", 32, 64, 1, (8, 8)))
    L.append(fc("fc", 64, 10))
    return Workload(name="resnet8", layers=tuple(L))


def ds_cnn() -> Workload:
    """MLPerf Tiny keyword spotting (DS-CNN small, 49x10 input)."""
    L = [conv("conv1", 1, 64, (10, 4), (25, 5))]
    for i in range(1, 5):
        L.append(conv(f"dw{i}", 64, 64, 3, (25, 5), groups=64))
        L.append(conv(f"pw{i}", 64, 64, 1, (25, 5)))
    L.append(fc("fc", 64, 12))
    return Workload(name="ds_cnn", layers=tuple(L))


def mobilenet_v1_025() -> Workload:
    """MLPerf Tiny visual wake words (MobileNetV1 width 0.25, 96x96x3)."""
    # (in_ch, out_ch, stride) for the dw/pw pairs after the stem.
    cfg = [(8, 16, 1), (16, 32, 2), (32, 32, 1), (32, 64, 2), (64, 64, 1),
           (64, 128, 2), (128, 128, 1), (128, 128, 1), (128, 128, 1),
           (128, 128, 1), (128, 128, 1), (128, 256, 2), (256, 256, 1)]
    hw = 48
    L = [conv("stem", 3, 8, 3, (48, 48))]
    for i, (cin, cout, s) in enumerate(cfg):
        hw = hw // s
        L.append(conv(f"dw{i}", cin, cin, 3, (hw, hw), groups=cin))
        L.append(conv(f"pw{i}", cin, cout, 1, (hw, hw)))
    L.append(fc("fc", 256, 2))
    return Workload(name="mobilenet_v1_025", layers=tuple(L))


def autoencoder() -> Workload:
    """MLPerf Tiny anomaly detection (FC autoencoder, 640-dim input)."""
    dims = [640, 128, 128, 128, 128, 8, 128, 128, 128, 128, 640]
    L = [fc(f"fc{i}", dims[i], dims[i + 1]) for i in range(len(dims) - 1)]
    return Workload(name="autoencoder", layers=tuple(L))


def mlperf_tiny_suite() -> list[Workload]:
    return [resnet8(), ds_cnn(), mobilenet_v1_025(), autoencoder()]


# ---------------------------------------------------------------------------
# LM-architecture extraction: flatten a transformer config into LayerSpecs.
# Each matmul y[S, out] = x[S, in] @ W[in, out] is one LayerSpec with
# K=out, C=in, OX=S (sequence positions are the temporal output loop).
# ---------------------------------------------------------------------------

def lm_workload(cfg, *, seq_len: int = 1, unique_layers: bool = False,
                fine: bool = False) -> Workload:
    """Flatten an `repro.configs` ModelConfig into an IMC workload.

    ``unique_layers=False`` emits one block and scales nothing — the packer is
    layer-shape driven and transformer blocks repeat; per-network totals can
    multiply by cfg.num_layers. ``unique_layers=True`` emits every block.

    ``fine=True`` extracts at the granularity real serving engines shard:
    per-head attention slices, per-expert FFN tiles and the family-specific
    small matrices (RWKV lora mixers, MLA down-projections, MoE routers).
    These ragged shapes underutilize the D_i x D_o plane individually —
    the regime where the paper's packing wins (DS-CNN analogue); block-
    granular dense LM layers fill the plane and pack trivially.
    """
    L: list[LayerSpec] = []
    blocks = cfg.num_layers if unique_layers else 1
    hd = cfg.head_dim
    D = cfg.d_model
    moe = getattr(cfg, "moe", None)
    for b in range(blocks):
        p = f"b{b}_"
        if fine:
            for h in range(min(cfg.num_heads, 4)):       # representative
                L.append(fc(p + f"q{h}", D, hd, ox=seq_len))
            for h in range(min(max(cfg.num_kv_heads, 1), 2)):
                L.append(fc(p + f"k{h}", D, hd, ox=seq_len))
                L.append(fc(p + f"v{h}", D, hd, ox=seq_len))
            L.append(fc(p + "o", cfg.num_heads * hd, D, ox=seq_len))
        else:
            L.append(fc(p + "q", D, cfg.num_heads * hd, ox=seq_len))
            L.append(fc(p + "k", D, cfg.num_kv_heads * hd, ox=seq_len))
            L.append(fc(p + "v", D, cfg.num_kv_heads * hd, ox=seq_len))
            L.append(fc(p + "o", cfg.num_heads * hd, D, ox=seq_len))
        if moe:
            fe = moe.d_ff_expert
            for e in range(min(moe.num_experts, 8)):
                L.append(fc(p + f"e{e}_up", D, fe, ox=seq_len))
                L.append(fc(p + f"e{e}_dn", fe, D, ox=seq_len))
            if fine:
                L.append(fc(p + "router", D, moe.num_experts, ox=seq_len))
        else:
            L.append(fc(p + "ff_up", D, cfg.d_ff, ox=seq_len))
            L.append(fc(p + "ff_gate", D, cfg.d_ff, ox=seq_len))
            L.append(fc(p + "ff_dn", cfg.d_ff, D, ox=seq_len))
        if fine and cfg.family == "ssm":                 # rwkv6 mixers
            L.append(fc(p + "mix_w1", D, 160, ox=seq_len))
            for i in range(5):
                L.append(fc(p + f"mix_w2_{i}", 32, D, ox=seq_len))
            L.append(fc(p + "w_lora_a", D, 64, ox=seq_len))
            L.append(fc(p + "w_lora_b", 64, D, ox=seq_len))
        if fine and getattr(cfg, "mla", None):           # deepseek MLA
            m = cfg.mla
            L.append(fc(p + "w_dkv", D, m.kv_lora_rank, ox=seq_len))
            L.append(fc(p + "w_kr", D, m.qk_rope_head_dim, ox=seq_len))
            for h in range(2):
                L.append(fc(p + f"w_uk{h}", m.kv_lora_rank,
                            m.qk_nope_head_dim, ox=seq_len))
    return Workload(name=f"lm_{cfg.name}{'_fine' if fine else ''}",
                    layers=tuple(L))
