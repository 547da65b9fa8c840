"""Port parity of ``repro_torch.training`` (optimizer, compression, train
step and loop) against ``repro.training``, on the same numpy inputs made
from a seed: AdamW (clipping, weight decay, a schedule) and SGD over 3
steps within 1e-6; ``warmup_cosine`` within 1e-6; ``compress`` masks
exactly and values within 1e-7 over 2 rounds of error feedback, and
``wire_bytes`` exactly; ``make_train_step`` on tiny xDeepFM with
``accum_steps`` 1 and 4 within 1e-5; ``run_loop`` kill-and-resume
equivalence, and its checkpoints readable by the reference's loop.  Every
``StragglerMonitor`` here runs on a fake clock, so no test depends on the
wall clock."""
from __future__ import annotations

import gc
import itertools
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.training as jt
from repro.data import CTRStream as JCTRStream
from repro.models import recsys as jrec
import repro_torch.training as tt
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.models import recsys as trec
from repro_torch.training.compression import EFState
from repro_torch.training.optimizer import global_norm
from repro_torch.training.train_loop import value_and_grad
from repro_torch.tree import leaves
from tests.conftest import reduced_spec

torch.set_num_threads(2)


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"w": a(40, 8), "emb": {"table": a(300, 4), "bias": a(3)},
            "layers": [{"k": a(8, 8)}, {"k": a(8, 2)}], "s": a()}


def _close(got_tree, want_tree, tol: float) -> None:
    g, w = leaves(params_to_numpy(got_tree)), jax.tree.leaves(want_tree)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.astype(np.float64) - b).max(initial=0.0) <= tol


def _t(tree):
    return params_from_numpy(tree, "cpu")


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("sched", [False, True])
@pytest.mark.parametrize("clip", [None, 1.0, 1e-3])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_three_steps_match(clip, wd, sched):
    lr_t = tt.warmup_cosine(1e-2, 2, 10) if sched else 1e-2
    lr_j = jt.warmup_cosine(1e-2, 2, 10) if sched else 1e-2
    topt = tt.AdamW(lr=lr_t, weight_decay=wd, clip_norm=clip)
    jopt = jt.AdamW(lr=lr_j, weight_decay=wd, clip_norm=clip)
    p0 = _tree(0)
    tp, jp = _t(p0), _j(p0)
    ts, js = topt.init(tp), jopt.init(jp)
    for i in range(3):
        g = _tree(10 + i)
        tp, ts = topt.update(_t(g), ts, tp)
        jp, js = jopt.update(_j(g), js, jp)
    _close(tp, jp, 1e-6)
    for f in ("mu", "nu", "master"):
        _close(getattr(ts, f), getattr(js, f), 1e-6)
    assert int(ts.step) == int(js.step) == 3
    assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("sched", [False, True])
def test_sgd_three_steps_match(momentum, sched):
    lr_t = tt.warmup_cosine(0.1, 1, 5) if sched else 0.1
    lr_j = jt.warmup_cosine(0.1, 1, 5) if sched else 0.1
    topt, jopt = tt.SGD(lr=lr_t, momentum=momentum), jt.SGD(
        lr=lr_j, momentum=momentum)
    tp, jp = _t(_tree(1)), _j(_tree(1))
    ts, js = topt.init(tp), jopt.init(jp)
    for i in range(3):
        g = _tree(20 + i)
        tp, ts = topt.update(_t(g), ts, tp)
        jp, js = jopt.update(_j(g), js, jp)
    _close(tp, jp, 1e-6)
    _close(ts.mu, js.mu, 1e-6)
    assert ts.nu == {} and int(ts.step) == 3


def test_adamw_bf16_params_keep_fp32_master():
    topt = tt.AdamW(lr=0.01)
    params = {"w": torch.zeros(8, dtype=torch.bfloat16)}
    state = topt.init(params)
    assert state.master["w"].dtype == torch.float32
    p2, s2 = topt.update({"w": torch.ones(8, dtype=torch.bfloat16)}, state,
                         params)
    assert p2["w"].dtype == torch.bfloat16
    assert s2.master["w"].dtype == torch.float32
    assert params["w"].abs().sum() == 0          # the params are not written
    assert s2.mu["w"] is state.mu["w"]           # the state is, in place
    assert int(state.step) == 0 and int(s2.step) == 1


@pytest.mark.parametrize("opt", [tt.AdamW(lr=0.1), tt.SGD(lr=0.1)])
def test_update_writes_neither_grads_nor_params(opt):
    params = {"w": torch.ones(5), "v": torch.ones(2, 70)}
    grads = {"w": torch.full((5,), 2.0), "v": torch.full((2, 70), 3.0)}
    state = opt.init(params)
    assert state.master["w"] is not params["w"]
    p2, s2 = opt.update(grads, state, params)
    assert torch.equal(params["w"], torch.ones(5))
    assert torch.equal(grads["v"], torch.full((2, 70), 3.0))
    assert not torch.equal(p2["w"], params["w"])
    # the returned params never alias the master: a second step, which
    # writes the master in place, leaves the first step's params as they were
    kept = {k: v.clone() for k, v in p2.items()}
    p3, _ = opt.update(grads, s2, p2)
    for k in p2:
        assert p2[k].data_ptr() != s2.master[k].data_ptr()
        assert torch.equal(p2[k], kept[k])
        assert not torch.equal(p3[k], kept[k])


def test_global_norm_matches():
    t = _tree(3)
    assert abs(float(global_norm(_t(t))) - float(jt.optimizer.global_norm(
        _j(t)))) <= 1e-5


@pytest.mark.parametrize("peak,warm,total,floor", [
    (1.0, 10, 100, 0.1), (3e-4, 0, 50, 0.0), (0.5, 7, 7, 0.2)])
def test_warmup_cosine_values(peak, warm, total, floor):
    ts = tt.warmup_cosine(peak, warm, total, floor)
    js = jt.warmup_cosine(peak, warm, total, floor)
    for step in range(0, total + 20, 3):
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - float(js(jnp.int32(step)))) <= 1e-6 * max(1, peak)


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"big": rng.standard_normal((50, 40)).astype(np.float32),
            "tied": rng.integers(-3, 4, (20, 10)).astype(np.float32),
            "small": rng.standard_normal(64).astype(np.float32),
            "nested": [rng.standard_normal(65).astype(np.float32)]}


@pytest.mark.parametrize("keep_frac", [0.01, 0.05, 0.3])
def test_compress_two_rounds_match(keep_frac):
    """Masks exact (a leaf of tied integer magnitudes included: the
    threshold is a value, so ties all pass in both), values within
    1e-7, over two rounds of error feedback."""
    g0 = _grads(0)
    tef, jef = tt.init_ef(_t(g0)), jt.init_ef(_j(g0))
    for rnd in range(2):
        g = _grads(rnd)
        ts, tef = tt.compress(_t(g), tef, keep_frac)
        js, jef = jt.compress(_j(g), jef, keep_frac)
        for a, b in zip(leaves(params_to_numpy(ts)), jax.tree.leaves(js)):
            assert np.array_equal(a != 0, np.asarray(b) != 0)
            assert np.abs(a - np.asarray(b)).max() <= 1e-7
        _close(tef.residual, jef.residual, 1e-7)
    assert isinstance(tef, EFState)
    # 64 elements go dense; 65 are sparsified
    assert bool((ts["small"] != 0).all())
    assert int((ts["nested"][0] != 0).sum()) < 65


@pytest.mark.parametrize("keep_frac", [0.0, 0.01, 0.5, 1.0])
def test_wire_bytes_exact(keep_frac):
    t = _tree(4)
    assert tt.wire_bytes(_t(t), keep_frac) == jt.wire_bytes(_j(t),
                                                            keep_frac)
    meta = {k: torch.empty(v.shape, device="meta") for k, v in
            _grads(0).items() if k != "nested"}
    assert tt.wire_bytes(meta, keep_frac) == jt.wire_bytes(
        {k: jnp.zeros(v.shape) for k, v in meta.items()}, keep_frac)


def test_grads_are_freed_without_the_cycle_collector():
    """A step's gradients go when their last reference does: no reference
    cycle keeps them (on the card they are gigabytes per microbatch)."""
    cfg = reduced_spec("xdeepfm").config
    params = trec.init_params(torch.Generator().manual_seed(0), cfg)
    b = {k: torch.as_tensor(v) for k, v in JCTRStream(cfg, 16)(0).items()}
    gc.disable()
    try:
        loss, g = value_and_grad(lambda p, x: trec.loss(p, x, cfg), params,
                                 b)
        refs = [weakref.ref(t) for t in leaves(g)]
        del g, loss
        assert not any(r() is not None for r in refs)
    finally:
        gc.enable()


def test_value_and_grad_gives_zeros_for_unused_leaves():
    params = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    loss, g = value_and_grad(lambda p, b: (p["a"] * b).sum(), params,
                             torch.arange(3.0))
    assert float(loss) == 3.0
    assert torch.equal(g["a"], torch.arange(3.0))
    assert torch.equal(g["b"], torch.zeros(2, 2))
    assert not params["a"].requires_grad


@pytest.mark.parametrize("compress_frac", [None, 0.2])
@pytest.mark.parametrize("accum", [1, 4])
def test_make_train_step_tiny_xdeepfm(accum, compress_frac):
    cfg = reduced_spec("xdeepfm").config
    jp = jrec.init_params(jax.random.PRNGKey(1), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    b = JCTRStream(cfg, 32, seed=2)(0)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    jopt, topt = jt.AdamW(lr=1e-3, weight_decay=0.01), tt.AdamW(
        lr=1e-3, weight_decay=0.01)
    jstep = jt.make_train_step(lambda p, x: jrec.loss(p, x, cfg), jopt,
                               accum_steps=accum, compress_frac=compress_frac)
    tstep = tt.make_train_step(lambda p, x: trec.loss(p, x, cfg), topt,
                               accum_steps=accum, compress_frac=compress_frac)
    jp2, js2, jef, jm = jstep(jp, jopt.init(jp), jt.init_ef(jp), jb)
    tp2, ts2, tef, tm = tstep(tp, topt.init(tp), tt.init_ef(tp), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5
    _close(tp2, jp2, 1e-5)
    _close(ts2.mu, js2.mu, 1e-5)
    _close(tef.residual, jef.residual, 1e-5)


def _toy():
    """The reference's toy regression (``tests/test_training.py``)."""
    W_true = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)

    def data(step):
        rng = np.random.default_rng([7, step])
        x = rng.normal(size=(16, 4)).astype(np.float32)
        return x, x @ W_true

    def tbatches(step):
        x, y = data(step)
        return {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}

    def jbatches(step):
        x, y = data(step)
        return {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    def tloss(p, b):
        return torch.mean(torch.square(b["x"] @ p["W"] - b["y"]))

    def jloss(p, b):
        return jnp.mean(jnp.square(b["x"] @ p["W"] - b["y"]))

    return tbatches, jbatches, tloss, jloss


def test_run_loop_learns_and_matches_reference(tmp_path):
    tb, jb, tloss, jloss = _toy()
    topt, jopt = tt.AdamW(lr=0.05), jt.AdamW(lr=0.05)
    tparams = {"W": torch.zeros(4, 3)}
    jparams = {"W": jnp.zeros((4, 3))}
    tcfg = tt.TrainLoopConfig(n_steps=40, ckpt_dir=str(tmp_path / "t"),
                              ckpt_every=20)
    jcfg = jt.TrainLoopConfig(n_steps=40, ckpt_dir=str(tmp_path / "j"),
                              ckpt_every=20)
    tp, _, th = tt.run_loop(tt.make_train_step(tloss, topt), tparams,
                            topt.init(tparams), tb, tcfg,
                            monitor=tt.StragglerMonitor(clock=_clock()))
    jp, _, jh = jt.run_loop(jt.make_train_step(jloss, jopt), jparams,
                            jopt.init(jparams), jb, jcfg,
                            monitor=jt.StragglerMonitor(clock=_clock()))
    assert th[-1] < th[0] * 0.1
    assert np.allclose(th, jh, rtol=1e-5, atol=1e-6)
    _close(tp, jp, 1e-5)
    assert tt.checkpoint.latest_step(str(tmp_path / "t")) == 40
    assert tt.checkpoint.all_steps(str(tmp_path / "t")) == [20, 40]


def test_run_loop_kill_resume_equivalence(tmp_path):
    """Training 30 straight == training 15, 'crashing', resuming to 30;
    the resumed run replays the same data, bit for bit."""
    tb, _, tloss, _ = _toy()
    opt = tt.AdamW(lr=0.05)
    step = tt.make_train_step(tloss, opt)
    params = {"W": torch.zeros(4, 3)}

    def run(n, d, resume=False):
        cfg = tt.TrainLoopConfig(n_steps=n, ckpt_dir=str(tmp_path / d),
                                 ckpt_every=5, resume=resume)
        return tt.run_loop(step, params, opt.init(params), tb, cfg,
                           monitor=tt.StragglerMonitor(clock=_clock()))

    pa, sa, ha = run(30, "a")
    _, _, hb1 = run(15, "b")
    pb, sb, hb2 = run(30, "b", resume=True)
    assert len(hb2) == 15 and hb1 + hb2 == ha
    assert torch.equal(pa["W"], pb["W"])
    assert int(sb.step) == int(sa.step) == 30


def test_port_checkpoint_resumes_in_the_reference_loop(tmp_path):
    """The port's loop writes (params, AdamWState) under the reference's
    leaf names: the reference's loop resumes from it and carries on."""
    tb, jb, tloss, jloss = _toy()
    topt, jopt = tt.AdamW(lr=0.05), jt.AdamW(lr=0.05)
    tparams = {"W": torch.zeros(4, 3)}
    cfg = tt.TrainLoopConfig(n_steps=10, ckpt_dir=str(tmp_path),
                             ckpt_every=10)
    tp, ts, _ = tt.run_loop(tt.make_train_step(tloss, topt), tparams,
                            topt.init(tparams), tb, cfg,
                            monitor=tt.StragglerMonitor(clock=_clock()))
    jparams = {"W": jnp.zeros((4, 3))}
    jcfg = jt.TrainLoopConfig(n_steps=10, ckpt_dir=str(tmp_path),
                              ckpt_every=10, resume=True)
    jp, js, jh = jt.run_loop(jt.make_train_step(jloss, jopt), jparams,
                             jopt.init(jparams), jb, jcfg,
                             monitor=jt.StragglerMonitor(clock=_clock()))
    assert jh == [] and int(js.step) == 10
    assert np.array_equal(np.asarray(jp["W"]), tp["W"].numpy())
    assert np.array_equal(np.asarray(js.nu["W"]), ts.nu["W"].numpy())


def test_straggler_shrink_checkpoints_and_stops(tmp_path):
    """A straggler policy trip checkpoints and leaves the loop, as the
    reference's."""
    tb, _, tloss, _ = _toy()
    opt = tt.AdamW(lr=0.05)
    t = [0.0]

    def clock():
        return t[0]

    class Slow:
        def __init__(self, step):
            self.step = step

        def __call__(self, params, s, ef, batch):
            t[0] += 1.0 if int(s.step) < 20 else 10.0
            return self.step(params, s, ef, batch)

    mon = tt.StragglerMonitor(window=20, straggler_ratio=2.0,
                              consecutive_to_shrink=2, clock=clock)
    params = {"W": torch.zeros(4, 3)}
    cfg = tt.TrainLoopConfig(n_steps=50, ckpt_dir=str(tmp_path),
                             ckpt_every=100)
    _, s, hist = tt.run_loop(Slow(tt.make_train_step(tloss, opt)), params,
                             opt.init(params), tb, cfg, monitor=mon)
    assert len(hist) == 22 and int(s.step) == 22
    assert tt.checkpoint.latest_step(str(tmp_path)) == 22
