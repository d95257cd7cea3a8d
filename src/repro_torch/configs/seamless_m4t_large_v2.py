"""seamless-m4t-large-v2 — audio encoder-decoder backbone. [arXiv:2308.11596; hf]
(copy of ``repro.configs.seamless_m4t_large_v2``)

The modality frontend is a stub: the caller passes precomputed audio-frame
embeddings of shape (batch, enc_len, d_model); the encoder is 24
bidirectional self-attention layers over those frames and the 24-layer
decoder cross-attends to the encoder output.
"""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,  # decoder layers
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,  # MHA
        d_head=64,
        d_ff=8192,
        vocab_size=256206,
        block_groups=((("global",), 24),),
        ffn_gated=False,
        enc_dec=True,
        n_enc_layers=24,
        enc_len_ratio=1.0,
        rope_theta=10_000.0,
        long_context_ok=False,  # full attention enc-dec: long_500k skipped
        notes="enc-dec; decode shapes lower the decoder serve_step w/ cross-attn",
        source="arXiv:2308.11596",
    )
)
