"""Gemma-3-1B: 26L d_model=1152 4H (MQA kv=1) head_dim=256 d_ff=6912
vocab=262144; 5:1 local:global sliding window (512), 32k context on 1b.

[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchSpec, LMConfig, LM_SHAPES, register

CONFIG = LMConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    act="geglu",
    window=512,
    global_every=6,          # 5 local : 1 global
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
)

SPEC = register(ArchSpec(
    arch_id="gemma3-1b",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    source="hf:google/gemma-3-1b-pt; unverified",
    notes="long_500k runs: 5/6 layers are 512-window local; global-layer KV "
          "shards over the model axis.",
))
