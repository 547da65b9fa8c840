"""Model families of the port: the CF, recsys, LM (dense and MoE) and
GNN families with their building blocks."""
from repro_torch.models import (attention, cf, embedding, gnn, layers, moe,
                                recsys, transformer)

__all__ = ["attention", "cf", "embedding", "gnn", "layers", "moe", "recsys",
           "transformer"]
