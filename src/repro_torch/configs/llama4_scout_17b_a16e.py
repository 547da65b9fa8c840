"""Llama-4-Scout-17B-16E: 48L d_model=5120 40H (GQA kv=8) expert d_ff=8192,
MoE 16e top-1 + 1 shared expert; chunked-local attention (8192-token chunks)
on 3 of every 4 layers with full (NoPE) attention on the 4th — iRoPE.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
17B active / 109B total. Early fusion (VLM frontend is out of scope here; the
LM backbone is what the assignment specifies).
"""
from repro_torch.configs.base import (ArchSpec, LMConfig, MoEConfig, LM_SHAPES,
                                register)

CONFIG = LMConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    act="swiglu",
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
    # Chunked/local attention with window 8192 on local layers; every 4th
    # layer is global full-attention -> long_500k is sub-quadratic overall.
    window=8192,
    global_every=4,
    rope_theta=500_000.0,
    tie_embeddings=False,
)

SPEC = register(ArchSpec(
    arch_id="llama4-scout-17b-a16e",
    family="lm",
    config=CONFIG,
    shapes=LM_SHAPES,
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    notes="long_500k runs: 3/4 layers chunked-local (8k window), KV for the "
          "global layers shards over the model axis.",
))
