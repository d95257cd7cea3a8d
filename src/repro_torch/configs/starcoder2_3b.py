"""starcoder2-3b — dense code model, GQA kv=2, RoPE. [arXiv:2402.19173; hf]
(copy of ``repro.configs.starcoder2_3b``)."""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="starcoder2-3b",
        family="dense",
        n_layers=30,
        d_model=3072,
        n_heads=24,
        n_kv_heads=2,
        d_head=128,
        d_ff=12288,
        vocab_size=49152,
        block_groups=((("global",), 30),),
        ffn_gated=False,
        rope_theta=999_999.4,
        long_context_ok=False,  # pure full attention: long_500k skipped
        notes="GQA kv=2; code workload",
        source="arXiv:2402.19173",
    )
)
