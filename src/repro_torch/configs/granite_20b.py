"""Granite-20B-Code: 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

[arXiv:2405.04324; hf:ibm-granite/granite-20b-code-base]
GPT-BigCode-style body (MQA kv=1, dense 4x GELU MLP). The assignment labels it
"llama-arch"; the published checkpoint uses MQA + dense GELU MLP, which the
kv=1 and d_ff=4*d here corroborate, so that is what we implement. Learned
absolute positions in the checkpoint are replaced by RoPE so the 32k decode
cells are well-defined (deviation recorded in DESIGN.md).
"""
from repro_torch.configs.base import (ArchSpec, LMConfig, LM_SHAPES,
                                FULL_ATTN_LONG_SKIP, register)

CONFIG = LMConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    vocab_size=49_152,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SPEC = register(ArchSpec(
    arch_id="granite-20b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    source="arXiv:2405.04324; hf",
    skip_shapes={"long_500k": FULL_ATTN_LONG_SKIP},
))
