"""whisper-tiny [audio] — arXiv:2212.04356, encoder-decoder.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865; conv frontend is a STUB —
requests carry precomputed frame embeddings (1500, 384) as their
``frames`` extra. Served by ``models.whisper`` through the static path
(``runtime.run_static``): it has no engine backend, as in the reference.
"""

from .base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    num_layers=4, d_model=384, num_heads=6, num_kv_heads=6,
    d_ff=1536, vocab_size=51865, head_dim=64,
    norm="layernorm", use_bias=True, qkv_bias=True,
    encoder=EncoderConfig(num_layers=4, seq_len=1500),
)
