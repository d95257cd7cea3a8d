"""granite-20b — dense code LLM, llama-arch, MQA (kv=1). [arXiv:2405.04324; hf]
(copy of ``repro.configs.granite_20b``)."""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,  # MQA
        d_head=128,
        d_ff=24576,
        vocab_size=49152,
        block_groups=((("global",), 52),),
        ffn_gated=False,
        rope_theta=10_000.0,
        long_context_ok=False,  # pure full attention: long_500k skipped
        notes="llama-arch code model; MQA makes KV tiny but un-shardable by head",
        source="arXiv:2405.04324",
    )
)
