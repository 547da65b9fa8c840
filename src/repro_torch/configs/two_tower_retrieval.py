"""Two-tower retrieval (YouTube / Yi et al. RecSys'19): embed_dim=256,
tower MLP 1024-512-256, dot-product interaction, in-batch sampled softmax
with logQ correction. [RecSys'19 (YouTube); unverified]

User tower: user-id + context fields; item tower: item-id + item fields.
This is the architecture the paper's TwinSearch technique attaches to: the
serving layer maintains per-user sorted similarity lists over tower
embeddings (see repro/serving/cf_server.py).
"""
from repro_torch.configs.base import ArchSpec, RecsysConfig, RECSYS_SHAPES, register
from repro_torch.configs._fields import powerlaw_vocabs

CONFIG = RecsysConfig(
    name="two-tower-retrieval",
    variant="two_tower",
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
    user_vocab=50_000_000,
    item_vocab=10_000_000,
    field_vocab_sizes=powerlaw_vocabs(6, largest=100_000, smallest=16,
                                      n_large=2),
    n_dense=0,
)

SPEC = register(ArchSpec(
    arch_id="two-tower-retrieval",
    family="recsys",
    config=CONFIG,
    shapes=RECSYS_SHAPES,
    source="RecSys'19 (YouTube); unverified",
))
