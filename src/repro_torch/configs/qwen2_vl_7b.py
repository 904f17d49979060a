"""qwen2-vl-7b [vlm] — arXiv:2409.12191.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064; M-RoPE (3-D
temporal/height/width rotary sections). Vision frontend is a STUB —
requests carry precomputed patch embeddings.
"""

from .base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    norm="rmsnorm", qkv_bias=True, mrope=True, rope_theta=1_000_000.0,
    encoder=EncoderConfig(num_layers=0, seq_len=256),  # patch stub only
)
