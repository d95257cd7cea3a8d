"""gemma3-4b — dense with 5:1 local:global attention, 128k-class context.
(copy of ``repro.configs.gemma3_4b``)

[hf:google/gemma-3-1b-pt; unverified]

34 layers = 5 x (5 local + 1 global) + 4 local remainder.  Local window 1024.
long_500k runs: local layers are window-bounded and the handful of global
layers decode against a sequence-sharded KV cache (O(seq) per decoded token —
decode cost is linear, only *prefill* of a 524k context would be quadratic,
and long_500k lowers serve_step only).
"""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="gemma3-4b",
        family="dense",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        d_head=256,
        d_ff=10240,
        vocab_size=262144,
        block_groups=(
            (("local", "local", "local", "local", "local", "global"), 5),
            (("local",), 4),
        ),
        window=1024,
        qk_norm=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_context_ok=True,
        notes="5:1 local:global; 262k vocab stresses embedding sharding + CE loss",
        source="hf:google/gemma-3-4b-pt",
    )
)
