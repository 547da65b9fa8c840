"""Port parity of ``repro_torch.models.transformer`` against
``repro.models.transformer`` for the five registered LM architectures at
their reduced configs (``tests/conftest.py::reduced_spec``: gemma3-1b and
llama4-scout keep their local/global window mix, olmoe and llama4-scout
their MoE, granite its MQA and GELU MLP, gemma-7b its MHA).  The
reference's params cross with ``bridge.params_from_numpy(device="cpu")``
and the same numpy tokens go to both:

  * ``forward``: the hidden states and the mean aux loss;
  * ``lm_loss`` and its gradients: the port's ``value_and_grad`` (autograd
    through checkpointed blocks) against ``jax.value_and_grad``;
  * ``prefill`` with S < W (the ring's negative positions) and S > W: the
    last-position logits and every cache leaf (``ring_pos`` exactly);
  * 4 ``decode_step``s after the prefill, the global cache grown to 32
    positions as ``LMServer`` grows it, each fed the reference's greedy
    token: the logits, the caches after the last step and, in float32, the
    greedy tokens themselves.

Every comparison runs in float32 (``dtype="float32"``) and in bfloat16
(the registered dtype, ``embed_scale`` rounded to bf16 included).  The
reference runs under ``jax.jit``, as its server and cells run it.

Tolerances.  Float32, tight: every element within 2e-5 of the largest
value of the compared tensor (float32 sums in other orders through up to
12 layers; measured at most 3e-6 of it), each gradient leaf within 1e-4
of its largest value (measured at most 3.2e-5), the loss and the aux loss
within 1e-6 relative; the greedy tokens equal.  Bfloat16, loose and
norm-wise: the RMS of the difference within 1/16 of the reference's RMS,
1/4 for each gradient leaf, the loss within 1e-2 relative and the aux
loss within 1e-3.  Norm-wise because bf16 rounding of the hidden states
flips top-1 routing choices that are near-ties: llama4-scout's reduced
config routes one token with a margin of 4.8e-3 in the router
probabilities, and that token's hidden state then differs by 0.56.
Measured: hidden states at most 2.8e-2 of the RMS (llama4-scout; 4.2e-3
for the others), gradients at most 0.107 (llama4-scout; 1.1e-2).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import transformer as jlm
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.configs import get_arch
from repro_torch.configs.base import LMConfig, MoEConfig, ShapeSpec
from repro_torch.models import transformer as tlm
from repro_torch.training.train_loop import value_and_grad
from repro_torch.tree import leaves
from tests.conftest import reduced_spec

torch.set_num_threads(2)

ARCHS = ("gemma3-1b", "gemma-7b", "granite-20b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e")
DTYPES = ("float32", "bfloat16")
B, S_LONG, S_SHORT, MAX_LEN, STEPS = 2, 16, 6, 32, 4


def _jcfg(arch, dtype=None):
    """The reference's reduced config of ``arch`` (its registered dtype
    unless ``dtype`` is given)."""
    cfg = reduced_spec(arch).config
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _cfg(arch, dtype=None):
    """The same config as the port's ``LMConfig``."""
    j = _jcfg(arch, dtype)
    kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    if j.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(j.moe))
    return LMConfig(**kw)


def _close(got, want, dtype, frac=None) -> float:
    """The difference over its bound for ``dtype`` (<= 1 passes): in
    float32 the largest |got - want| over ``frac`` (2e-5) of the largest
    |want|; in bfloat16 the RMS of the difference over ``frac`` (1/16) of
    the RMS of ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if dtype == "float32":
        err, ref = np.abs(got - want).max(), np.abs(want).max()
        frac = frac or 2e-5
    else:
        err = np.sqrt(np.mean((got - want) ** 2))
        ref = np.sqrt(np.mean(want ** 2))
        frac = frac or 1 / 16
    return float(err / (frac * ref)) if ref > 0 else float(err > 0) * 2


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


@functools.lru_cache(maxsize=None)
def _reference_params(arch):
    """The reference's float32 params of ``arch`` (numpy).  Its bf16 params
    are these cast to bf16, the router excepted: ``init_params`` draws in
    float32 and casts."""
    jcfg = _jcfg(arch, "float32")
    params = jax.jit(lambda k: jlm.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, params)


def _params_in(params: dict, dtype: str) -> dict:
    dt = jnp.dtype(dtype)
    return {k: (_params_in(v, dtype) if isinstance(v, dict) else
                jnp.asarray(v) if k == "router" else
                jnp.asarray(v).astype(dt))
            for k, v in params.items()}


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's params (numpy), tokens and every output the tests
    compare, computed once per (arch, dtype) through ``jax.jit``, as its
    server and cells run them."""
    cfg, jcfg = _cfg(arch, dtype), _jcfg(arch, dtype)
    params = _params_in(_reference_params(arch), dtype)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (B, S_LONG)).astype(np.int32)
    out = {"params": jax.tree.map(np.asarray, params), "tokens": tokens}
    h, aux = jax.jit(lambda p, t: jlm.forward(p, t, jcfg))(params, tokens)
    out["forward"] = (_np(h), float(aux))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.lm_loss(p, t, jcfg, loss_chunk=8)))(params, tokens)
    out["loss"] = (float(loss), _np(grads))
    prefill = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg))
    decode = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos,
                                                          jcfg))
    for S in _prefill_lengths(cfg):
        logits, cache = prefill(params, tokens[:, :S])
        out[f"prefill{S}"] = (_np(logits), _np(cache))
    # decode after the long prefill, the global cache grown as LMServer
    # grows it; each step fed the reference's own greedy token
    logits, cache = prefill(params, tokens)
    cache = dict(cache)
    for k in ("kg", "vg"):
        cache[k] = jnp.pad(cache[k], ((0, 0), (0, 0), (0, MAX_LEN - S_LONG),
                                      (0, 0), (0, 0)))
    feed, steps = [], []
    tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    for i in range(STEPS):
        feed.append(np.asarray(tok))
        logits, cache = decode(params, cache, tok, jnp.int32(S_LONG + i))
        steps.append(_np(logits))
        tok = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out["decode"] = (feed, steps, _np(cache))
    return cfg, out


def _prefill_lengths(cfg) -> tuple[int, ...]:
    """S > W for every config; S < W too where there is a window."""
    return (S_SHORT, S_LONG) if cfg.window is not None else (S_LONG,)


@pytest.fixture
def case(request):
    """(arch, dtype, port config, the reference's outputs, the reference's
    params carried to the port on the CPU)."""
    arch, dtype = request.param
    cfg, out = _reference(arch, dtype)
    params = params_from_numpy(out["params"], device="cpu")
    for p, w in zip(leaves(params), leaves(tlm.param_structs(cfg))):
        assert p.dtype == w.dtype and p.shape == w.shape
    return arch, dtype, cfg, out, params


CASES = [(a, d) for a in ARCHS for d in DTYPES]
IDS = [f"{a}-{d}" for a, d in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS, indirect=True)
def test_forward_matches_reference(case):
    arch, dtype, cfg, out, params = case
    h, aux = tlm.forward(params, torch.tensor(out["tokens"]), cfg)
    jh, jaux = out["forward"]
    assert h.dtype == getattr(torch, dtype)
    assert _close(h.float(), jh, dtype) <= 1
    rel = 1e-6 if dtype == "float32" else 1e-3
    assert abs(float(aux) - jaux) <= rel * max(abs(jaux), 1.0)


@pytest.mark.parametrize("case", CASES, ids=IDS, indirect=True)
def test_lm_loss_and_gradients_match_reference(case):
    arch, dtype, cfg, out, params = case
    tokens = torch.tensor(out["tokens"])
    loss, grads = value_and_grad(
        lambda p, b: tlm.lm_loss(p, b, cfg, loss_chunk=8), params, tokens)
    jloss, jgrads = out["loss"]
    rel = 1e-6 if dtype == "float32" else 1e-2
    assert abs(float(loss) - jloss) <= rel * abs(jloss)
    got = params_to_numpy(grads)
    frac = 1e-4 if dtype == "float32" else 1 / 4
    for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                               leaves(got)):
        assert _close(g, want, dtype, frac) <= 1, jax.tree_util.keystr(path)


def _cache_close(got: dict, want: dict, dtype):
    assert set(got) == set(want)
    for k in want:
        g = got[k].float().numpy() if got[k].is_floating_point() else \
            got[k].numpy()
        assert g.shape == want[k].shape, k
        if k == "ring_pos":
            assert np.array_equal(g, want[k])
        else:
            assert _close(g, want[k], dtype) <= 1, k


PREFILL = [((a, d), S) for a, d in CASES
           for S in _prefill_lengths(_cfg(a))]


@pytest.mark.parametrize("case,S", PREFILL, indirect=["case"], ids=[
    f"{a}-{d}-{'S<W' if S < 8 else 'S>W'}" for (a, d), S in PREFILL])
def test_prefill_matches_reference(case, S):
    arch, dtype, cfg, out, params = case
    logits, cache = tlm.prefill(params, torch.tensor(out["tokens"][:, :S]),
                                cfg)
    jlogits, jcache = out[f"prefill{S}"]
    assert logits.dtype == torch.float32
    assert _close(logits, jlogits, dtype) <= 1
    _cache_close(cache, jcache, dtype)
    if cfg.window is not None and S < cfg.window:
        assert (cache["ring_pos"] < 0).any()


@pytest.mark.parametrize("case", CASES, ids=IDS, indirect=True)
def test_decode_steps_match_reference(case):
    arch, dtype, cfg, out, params = case
    feed, jsteps, jcache = out["decode"]
    with torch.no_grad():
        logits, cache = tlm.prefill(params, torch.tensor(out["tokens"]), cfg)
        for k in ("kg", "vg"):
            c = cache[k]
            grown = c.new_zeros((*c.shape[:2], MAX_LEN, *c.shape[3:]))
            grown[:, :, :S_LONG] = c
            cache[k] = grown
        for i in range(STEPS):
            if dtype == "float32":
                assert np.array_equal(
                    torch.argmax(logits, -1).numpy(), feed[i][:, 0])
            logits, cache = tlm.decode_step(params, cache,
                                            torch.tensor(feed[i]),
                                            S_LONG + i, cfg)
            assert _close(logits, jsteps[i], dtype) <= 1, i
    _cache_close(cache, jcache, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_structs_match_reference(arch):
    """Params, caches and cell inputs as ``meta`` tensors: the reference's
    shapes and dtypes, leaf by leaf in ``jax.tree.leaves`` order."""
    cfg, jcfg = _cfg(arch), _jcfg(arch)
    shape = ShapeSpec("decode_32k", "decode",
                      {"seq_len": 64, "global_batch": 3})
    pairs = [(tlm.param_structs(cfg), jlm.param_structs(jcfg)),
             (tlm.cache_structs(cfg, 3, 64), jlm.cache_structs(jcfg, 3, 64)),
             (tlm.input_structs(cfg, shape), jlm.input_structs(jcfg, shape))]
    for got, want in pairs:
        got, want = leaves(got), jax.tree.leaves(want)
        assert len(got) == len(want)
        for t, s in zip(got, want):
            assert t.is_meta and tuple(t.shape) == s.shape
            assert str(t.dtype).removeprefix("torch.") == \
                np.dtype(s.dtype).name
    assert tlm.layer_windows(cfg).tolist() == \
        np.asarray(jlm.layer_windows(jcfg)).tolist()
    assert tlm.GLOBAL_WINDOW == jlm.GLOBAL_WINDOW


def test_embed_scale_is_rounded_to_bf16():
    """At gemma3-1b's d = 1152 the bf16 scale is 34.0 (√1152 = 33.94)."""
    cfg = get_arch("gemma3-1b").config
    params = {"embed": torch.ones((4, cfg.d_model), dtype=torch.bfloat16)}
    x = tlm.embed_tokens(params, torch.tensor([[1, 2]]), cfg)
    assert x.dtype == torch.bfloat16 and float(x[0, 0, 0]) == 34.0
    want = jlm.embed_tokens({"embed": jnp.ones((4, cfg.d_model),
                                               jnp.bfloat16)},
                            jnp.asarray([[1, 2]]), cfg)
    assert float(want[0, 0, 0]) == 34.0


def test_init_params_draws_from_the_generator():
    cfg = _cfg("olmoe-1b-7b")
    a = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    b = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    c = tlm.init_params(torch.Generator().manual_seed(1), cfg)
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["router"].dtype == torch.float32
    assert a["embed"].dtype == torch.bfloat16
    assert sum(t.numel() for t in leaves(a)) == cfg.param_count()


def test_moe_ep_hook_is_not_ported():
    """The ``moe_ep`` hook selects ``moe_ffn_ep``, which needs its
    ``MoEEPInfo``'s mesh and raises without one (the hook was a stub that
    raised ``NotImplementedError`` until the expert-parallel path landed;
    ``tests/test_torch_moe_ep.py`` runs it)."""
    from repro_torch.distributed.sharding import P
    from repro_torch.models.moe_ep import MoEEPInfo
    cfg = _cfg("olmoe-1b-7b", "float32")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    hooks = tlm.LMShardingHooks(moe_ep=MoEEPInfo(
        dp=("data",), mp="model", mp_size=1, win_spec=P("model", None, None),
        wout_spec=P("model", None, None), acts_spec=P(("data",), None, None)))
    with pytest.raises(RuntimeError, match="info.mesh"):
        tlm.forward(params, torch.zeros((1, 8), dtype=torch.int32), cfg,
                    hooks)
    # the other hooks are accepted and change nothing
    tokens = torch.randint(0, cfg.vocab_size, (1, 8), dtype=torch.int32)
    plain = tlm.forward(params, tokens, cfg)[0]
    hooked = tlm.forward(params, tokens, cfg, tlm.LMShardingHooks(
        acts="a", logits="l", moe_tokens="t", moe_experts="e"))[0]
    assert torch.equal(plain, hooked)


def test_decode_refuses_a_position_past_the_cache():
    cfg = _cfg("gemma3-1b", "float32")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    cache = tlm.init_cache(cfg, 1, 16, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tlm.decode_step(params, cache, torch.zeros((1, 1), dtype=torch.int32),
                        16, cfg)


def test_init_cache_defaults_to_the_card():
    """The cache is made on the card unless the caller asks for the CPU or
    ``meta``; without a card the default raises instead of sliding onto
    the CPU."""
    cfg = _cfg("gemma3-1b", "float32")
    assert tlm.init_cache(cfg, 2, 16, device="cpu")["kg"].device.type == \
        "cpu"
    assert tlm.cache_structs(cfg, 2, 16)["kl"].is_meta
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlm.init_cache(cfg, 2, 16)
