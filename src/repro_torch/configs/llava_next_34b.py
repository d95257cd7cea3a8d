"""llava-next-34b — VLM text backbone (Yi-34B-class), anyres tiling stubbed.
(copy of ``repro.configs.llava_next_34b``)

[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower is a stub: the caller passes precomputed patch embeddings
(batch, n_patches, d_model) that are prepended to the text-token embeddings
(anyres tiling produces up to 5 tiles x 576 patches; one base tile is
provisioned by default).
"""
from repro_torch.configs.base import ArchConfig, register

register(
    ArchConfig(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_head=128,
        d_ff=20480,
        vocab_size=64000,
        block_groups=((("global",), 60),),
        n_patches=576,
        rope_theta=5_000_000.0,
        long_context_ok=False,  # pure full attention: long_500k skipped
        notes="patch embeddings occupy the first 576 positions of the sequence",
        source="hf:llava-hf/llava-v1.6-34b-hf",
    )
)
