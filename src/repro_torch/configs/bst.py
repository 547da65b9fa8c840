"""BST (Behavior Sequence Transformer, Alibaba): embed_dim=32, seq_len=20,
1 transformer block, 8 heads, MLP 1024-512-256. [arXiv:1905.06874; paper]

User behaviour sequence (item ids + positions) + target item through one
transformer block; concatenated with "other features" embeddings into the
MLP -> CTR logit.  Item vocabulary 4M (Taobao-scale); 8 side-feature fields.
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES, register
from repro_torch.configs._fields import powerlaw_vocabs

CONFIG = RecsysConfig(
    name="bst",
    variant="bst",
    embed_dim=32,
    item_vocab=4_000_000,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
    field_vocab_sizes=powerlaw_vocabs(8, largest=1_000_000, smallest=8,
                                      n_large=2),
    n_dense=0,
)

SPEC = register(ArchSpec(
    arch_id="bst",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    source="arXiv:1905.06874; paper",
))
