"""rwkv6-7b (Finch) — attention-free, data-dependent decay WKV
(copy of ``repro.configs.rwkv6_7b``). [arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ArchConfig, RWKVSpec, register

register(
    ArchConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=64,  # WKV heads of size 64
        n_kv_heads=64,
        d_head=64,
        d_ff=14336,
        vocab_size=65536,
        block_groups=((("rwkv",), 32),),
        rwkv=RWKVSpec(head_dim=64, ddlerp_rank=32, decay_rank=64),
        long_context_ok=True,
        notes="O(1) decode state: (heads, 64, 64) WKV matrix per layer",
        source="arXiv:2404.05892",
    )
)
