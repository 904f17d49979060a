"""olmoe-1b-7b [moe] — arXiv:2409.02060.

16L d_model=2048 16H (kv=16) vocab=50304; MoE FFN with 64 experts, top-8,
d_ff_expert=1024 (1B active / 7B total). Served by the GQA branch of
``models.moe`` through the static path (``runtime.run_static``): it has no
engine backend, as in the reference.
"""

from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    norm="rmsnorm",
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024),
)
