"""Gemma-7B: 28L d_model=3072 16H (MHA kv=16) head_dim=256 d_ff=24576
vocab=256000, GeGLU. [arXiv:2403.08295; hf:google/gemma-7b]
"""
from repro_torch.configs.base import (ArchSpec, LMConfig, LM_SHAPES,
                                FULL_ATTN_LONG_SKIP, register)

CONFIG = LMConfig(
    name="gemma-7b",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24_576,
    vocab_size=256_000,
    act="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

SPEC = register(ArchSpec(
    arch_id="gemma-7b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    source="arXiv:2403.08295; hf",
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
))
