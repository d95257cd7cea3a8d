"""rsc-llm — paper-representative LLaMa-style 7B-class pretraining workload
(copy of ``repro.configs.rsc_llm``)."""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="rsc-llm",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_head=128,
        d_ff=11008,
        vocab_size=32000,
        block_groups=((("global",), 32),),
        rope_theta=10_000.0,
        long_context_ok=False,
        notes="paper-representative LLaMa-class pretraining job",
        source="arXiv:2302.13971",
    )
)
