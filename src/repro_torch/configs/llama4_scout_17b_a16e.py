"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, chunked attention.
(copy of ``repro.configs.llama4_scout_17b_a16e``)

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Chunked (8192) attention bounds the decode KV cache, so long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, MoESpec, register

register(
    ArchConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_head=128,
        d_ff=8192,
        vocab_size=202048,
        block_groups=((("chunked",), 48),),
        window=8192,
        moe=MoESpec(
            n_experts=16,
            top_k=1,
            capacity_factor=2.0,
            shared_expert=True,
            group_size=1024,
        ),
        rope_theta=500_000.0,
        long_context_ok=True,
        notes="top-1 routed + always-on shared expert; early-fusion frontend stubbed",
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
)
