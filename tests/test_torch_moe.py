"""Port parity of ``repro_torch.models.moe`` against ``repro.models.moe``:
``moe_ffn`` on the same numpy inputs and weights, for SwiGLU, GeGLU and
GELU experts, with and without a shared expert, in one group and in
groups smaller than the batch (``group_size < T``), at the default
capacity and at a capacity factor low enough that choices are dropped;
both the output ``y`` and the aux loss are compared, and ``_capacity``
equals the reference's.

Tolerances: float32 within 2e-6 on ``y`` and 1e-6 on ``aux`` (float32 sums
in another order; the routing is the same, since the router logits are
float32 in both packages and top-k ties go to the lower expert);
bfloat16 within max|reference|/32 on ``y``, four bf16 ulps of its largest
value (each product and activation is rounded to bf16 on both sides, the
reference's elementwise steps one by one, the port's fused; measured: at
most 1.6 ulps over 120 seeded cases), and 1e-6 on ``aux`` (computed from
float32 router probabilities).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe as jmoe
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe as tmoe

torch.set_num_threads(2)

D, E, F_EXP = 32, 4, 16


def _weights(seed, act, shared, dtype):
    rng = np.random.default_rng(seed)
    gf = 2 if act in ("swiglu", "geglu") else 1

    def w(*shape):                     # fan-in scale, as init_params
        a = (rng.standard_normal(shape) * shape[-2] ** -0.5).astype(
            np.float32)
        if dtype == "bfloat16":
            a = np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
        return a

    ws = {"router": (rng.standard_normal((D, E)) * D ** -0.5).astype(
              np.float32),
          "w_in": w(E, D, gf * F_EXP), "w_out": w(E, F_EXP, D)}
    if shared:
        ws["shared"] = (w(D, gf * F_EXP), w(F_EXP, D))
    return ws


def _run(x, ws, cfg_kw, act, dtype, group_size):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jcfg, tcfg = JMoEConfig(**cfg_kw), MoEConfig(**cfg_kw)
    jsh = tsh = None
    if "shared" in ws:
        jsh = tuple(jnp.asarray(a, jdt) for a in ws["shared"])
        tsh = tuple(torch.tensor(a).to(tdt) for a in ws["shared"])
    jy, jaux = jmoe.moe_ffn(
        jnp.asarray(x, jdt), jnp.asarray(ws["router"]),
        jnp.asarray(ws["w_in"], jdt), jnp.asarray(ws["w_out"], jdt), jsh,
        jcfg, act, group_size=group_size)
    ty, taux = tmoe.moe_ffn(
        torch.tensor(x).to(tdt), torch.tensor(ws["router"]),
        torch.tensor(ws["w_in"]).to(tdt), torch.tensor(ws["w_out"]).to(tdt),
        tsh, tcfg, act, group_size=group_size)
    assert ty.dtype == tdt and taux.dtype == torch.float32
    return (ty.float().numpy(), float(taux),
            np.asarray(jy.astype(jnp.float32)), float(jaux))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("group_size", [4096, 8])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_moe_ffn_matches_reference(act, shared, group_size, capacity_factor,
                                   dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    ws = _weights(5, act, shared, dtype)
    cfg_kw = dict(n_experts=E, top_k=2, d_ff_expert=F_EXP,
                  n_shared=int(shared), capacity_factor=capacity_factor)
    y, aux, jy, jaux = _run(x, ws, cfg_kw, act, dtype, group_size)
    tol = 2e-6 if dtype == "float32" else np.abs(jy).max() / 32
    assert np.abs(y - jy).max() <= tol
    assert abs(aux - jaux) <= 1e-6


def test_low_capacity_drops_choices():
    """At capacity factor 0.25 a group of 32 tokens with 2 choices over 4
    experts has 8 slots an expert (the floor) for 16 choices on average:
    some are dropped, so the output differs from the one at capacity factor
    4, and both match the reference within 2e-6."""
    cfg = MoEConfig(n_experts=E, top_k=2, d_ff_expert=F_EXP,
                    capacity_factor=0.25)
    assert tmoe._capacity(32, cfg) == 8
    ws = _weights(5, "swiglu", False, "float32")
    x = np.random.default_rng(2).standard_normal((1, 32, D)).astype(
        np.float32)
    args = [torch.tensor(ws[k]) for k in ("router", "w_in", "w_out")]
    dropped, _ = tmoe.moe_ffn(torch.tensor(x), *args, None, cfg, "swiglu")
    full, _ = tmoe.moe_ffn(torch.tensor(x), *args, None,
                           dataclasses.replace(cfg, capacity_factor=4.0),
                           "swiglu")
    assert (dropped - full).abs().amax(dim=-1).gt(1e-6).any()
    for c, got in ((cfg, dropped), (dataclasses.replace(
            cfg, capacity_factor=4.0), full)):
        jy, _ = jmoe.moe_ffn(jnp.asarray(x), *(jnp.asarray(ws[k]) for k in (
            "router", "w_in", "w_out")), None, JMoEConfig(
                **dataclasses.asdict(c)), "swiglu")
        assert np.abs(got.numpy() - np.asarray(jy)).max() <= 2e-6


@pytest.mark.parametrize("gs", [1, 7, 8, 9, 100, 4096])
@pytest.mark.parametrize("k,cf", [(1, 1.25), (2, 0.25), (8, 1.0)])
def test_capacity_matches_reference(gs, k, cf):
    kw = dict(n_experts=64, top_k=k, d_ff_expert=8, capacity_factor=cf)
    assert tmoe._capacity(gs, MoEConfig(**kw)) == \
        jmoe._capacity(gs, JMoEConfig(**kw))


def test_ragged_groups_are_refused():
    cfg = MoEConfig(n_experts=E, top_k=2, d_ff_expert=F_EXP)
    ws = _weights(1, "gelu", False, "float32")
    with pytest.raises(ValueError, match="groups of 8"):
        tmoe.moe_ffn(torch.zeros((1, 12, D)), *(torch.tensor(ws[k]) for k in
                                               ("router", "w_in", "w_out")),
                     None, cfg, "gelu", group_size=8)
