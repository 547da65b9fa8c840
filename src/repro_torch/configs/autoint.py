"""AutoInt: 39 sparse fields, embed_dim=16, 3 self-attn layers, 2 heads,
d_attn=32. [arXiv:1810.11921; paper]
Multi-head self-attention over field embeddings with residual connections;
final layer concatenates all field outputs into the CTR logit.
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES, register
from repro_torch.configs._fields import CRITEO39

CONFIG = RecsysConfig(
    name="autoint",
    variant="autoint",
    embed_dim=16,
    field_vocab_sizes=CRITEO39,
    n_dense=13,
    n_attn_layers=3,
    n_attn_heads=2,
    d_attn=32,
)

SPEC = register(ArchSpec(
    arch_id="autoint",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    source="arXiv:1810.11921; paper",
))
