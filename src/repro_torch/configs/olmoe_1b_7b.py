"""OLMoE-1B-7B: 16L d_model=2048 16H (MHA kv=16) d_ff=1024/expert, 64e top-8.

[arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924]
1B active / 7B total parameters; no shared expert; full attention.
"""
from repro_torch.configs.base import (ArchSpec, LMConfig, MoEConfig, LM_SHAPES,
                                FULL_ATTN_LONG_SKIP, register)

CONFIG = LMConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    act="swiglu",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, n_shared=0),
    rope_theta=10_000.0,
    tie_embeddings=False,
)

SPEC = register(ArchSpec(
    arch_id="olmoe-1b-7b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    source="arXiv:2409.02060; hf",
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
))
