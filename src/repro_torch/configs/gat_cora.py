"""GAT (Cora config): 2 layers, 8 hidden units x 8 heads, attention aggregator.

[arXiv:1710.10903; paper] First layer 8 heads x 8 units concatenated (ELU),
second layer 1 output head (n_classes) for full-graph transductive cells;
the sampled / batched cells reuse the same layer config.
"""
from repro_torch.configs.base import ArchSpec, GNNConfig, GNN_SHAPES, register

CONFIG = GNNConfig(
    name="gat-cora",
    n_layers=2,
    d_hidden=8,
    n_heads=8,
    aggregator="attn",
    n_classes=7,
)

SPEC = register(ArchSpec(
    arch_id="gat-cora",
    family="gnn",
    config=CONFIG,
    shapes=GNN_SHAPES,
    source="arXiv:1710.10903; paper",
))
