"""Model families of the port.  Only the CF family is here; the LM, MoE,
GNN and recsys models come after it."""
from repro_torch.models import cf

__all__ = ["cf"]
