"""Model families of the port: the CF, recsys and LM (dense and MoE)
families with their building blocks.  The GNN family comes after them."""
from repro_torch.models import (attention, cf, embedding, layers, moe,
                                recsys, transformer)

__all__ = ["attention", "cf", "embedding", "layers", "moe", "recsys",
           "transformer"]
