"""recurrentgemma-9b — RG-LRU + local attention hybrid, 1 attn : 2 recurrent
(copy of ``repro.configs.recurrentgemma_9b``). [arXiv:2402.19427]

38 layers = 12 x (rglru, rglru, local-attn) + 2 rglru remainder.  Local
attention window 2048.  O(1) recurrent state makes long_500k decode natural.
"""
from repro_torch.configs.base import ArchConfig, RGLRUSpec, register

register(
    ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,  # MQA on the attention layers
        d_head=256,
        d_ff=12288,
        vocab_size=256000,
        block_groups=(
            (("rglru", "rglru", "local"), 12),
            (("rglru",), 2),
        ),
        window=2048,
        rglru=RGLRUSpec(lru_width=4096, conv_width=4, n_heads=16),
        rope_theta=10_000.0,
        tie_embeddings=True,
        long_context_ok=True,
        notes="RG-LRU linear recurrence; attention bounded at window 2048",
        source="arXiv:2402.19427",
    )
)
