"""xDeepFM: 39 sparse fields, embed_dim=10, CIN 200-200-200, deep MLP 400-400.

[arXiv:1803.05170; paper] Linear (wide) + CIN + DNN branches summed into the
CTR logit; CIN layer k: outer product of X^k with X^0 compressed by a 1x1
conv (H_{k+1} filters over H_k * F input channels).
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES, register
from repro_torch.configs._fields import CRITEO39

CONFIG = RecsysConfig(
    name="xdeepfm",
    variant="xdeepfm",
    embed_dim=10,
    field_vocab_sizes=CRITEO39,
    n_dense=13,
    mlp_dims=(400, 400),
    cin_layers=(200, 200, 200),
)

SPEC = register(ArchSpec(
    arch_id="xdeepfm",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    source="arXiv:1803.05170; paper",
))
