"""qwen3-0.6b — dense, GQA kv=8, qk-norm, tied embeddings
(copy of ``repro.configs.qwen3_0_6b``)."""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="qwen3-0.6b",
        family="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        d_head=128,  # qwen3 uses head_dim 128 (> d_model/n_heads)
        d_ff=3072,
        vocab_size=151936,
        block_groups=((("global",), 28),),
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_context_ok=False,
        notes="qk_norm per-head RMSNorm; vocab-dominated parameter budget",
        source="hf:Qwen/Qwen3-0.6B",
    )
)
