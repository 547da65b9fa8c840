"""Model families of the port: the CF family and the recsys family with
their building blocks.  The LM, MoE and GNN models come after them."""
from repro_torch.models import cf, embedding, layers, recsys

__all__ = ["cf", "embedding", "layers", "recsys"]
