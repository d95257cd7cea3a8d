"""mixtral-8x22b — MoE 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]
(copy of ``repro.configs.mixtral_8x22b``)."""
from repro_torch.configs.base import ArchConfig, MoESpec, register

register(
    ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_head=128,
        d_ff=16384,
        vocab_size=32768,
        block_groups=((("local",), 56),),
        window=4096,  # sliding-window attention
        moe=MoESpec(
            n_experts=8,
            top_k=2,
            capacity_factor=1.25,
            shared_expert=False,
            group_size=1024,
        ),
        rope_theta=1_000_000.0,
        long_context_ok=True,  # SWA bounds decode KV at the window
        notes="largest assigned model (~140B total params); checkpoint-size stress",
        source="arXiv:2401.04088",
    )
)
