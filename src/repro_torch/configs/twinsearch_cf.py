"""The paper's own system: neighbourhood-based CF with TwinSearch new-user
onboarding.  [Lu & Shen 2015, cs.IR]

Shapes mirror the paper's two datasets (MovieLens-100k 943x1682, Douban
129,490x58,541) plus a web-scale onboarding cell that exercises the
distributed path at 1M users. c=8 probes; the static candidate bound is the
paper's n/125 Gaussian bound with 1.5x slack.
"""
from repro_torch.configs.base import ArchSpec, CFConfig, CF_SHAPES, register

CONFIG = CFConfig(
    name="twinsearch-cf",
    mode="user",
    similarity="cosine",
    c_probes=8,
    set0_divisor=125,
    set0_slack=1.5,
    sim_tol=0.0,
)

SPEC = register(ArchSpec(
    arch_id="twinsearch-cf",
    family="cf",
    config=CONFIG,
    shapes=CF_SHAPES,
    source="Lu & Shen 2015 (the reproduced paper)",
    notes="Extra arch beyond the 40 assigned cells; hosts the paper's "
          "technique and its benchmarks.",
))
