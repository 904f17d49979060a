"""olmo-1b [dense] — arXiv:2402.00838.

16L d_model=2048 16H (kv=16) d_ff=8192 vocab=50304; non-parametric LayerNorm
(no learnable affine), no biases, SwiGLU, tied embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304, head_dim=128,
    norm="nonparametric", tie_embeddings=True,
)
