"""The port's training launcher (``python -m repro_torch.launch.train``) on
the CPU at a tiny registered spec (``get_arch`` monkeypatched to the
reduced config of ``tests/conftest.py`` with a small train batch): it
starts from zeros, as the reference launcher does, writes a checkpoint,
and resumes from it; from zeros only the wide branch and the last bias
move, and two steps equal the reference's train step (AdamW, jax.grad)
from the same zeros on the same batches within 1e-6.  The lm family (a
tiny gemma3-1b and olmoe on ``TokenPipeline`` batches) runs two steps from
zeros equal to the reference's train step within 1e-6: every gradient is
zero and the loss stays ln V (plus the aux weight for the MoE).  The JAX
mesh options and a shape that is not a train shape exit with a message;
the card is the default device."""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import CTRStream as JCTRStream
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import recsys as jrec
from repro.models import transformer as jlm
from repro.training import AdamW as JAdamW
from repro_torch.bridge import params_to_numpy
from repro_torch.configs.base import LMConfig, MoEConfig, ShapeSpec
from repro_torch.launch import train as launcher
from repro_torch.training import checkpoint
from repro_torch.tree import leaves
from tests.conftest import reduced_spec

torch.set_num_threads(2)

BATCH = 32


def _tiny(arch: str):
    spec = reduced_spec(arch)
    if spec.family == "lm":
        # the reference's reduced config as the port's LMConfig, at a tiny
        # train_4k shape
        j = spec.config
        kw = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
        if j.moe is not None:
            kw["moe"] = MoEConfig(**dataclasses.asdict(j.moe))
        shape = ShapeSpec("train_4k", "train", {"seq_len": 16,
                                                "global_batch": 4})
        return dataclasses.replace(spec, config=LMConfig(**kw),
                                   shapes=(shape,))
    shape = ShapeSpec("train_batch", "train", {"batch": BATCH})
    return dataclasses.replace(spec, shapes=(shape,))


@pytest.fixture
def tiny(monkeypatch):
    specs = {}

    def get_arch(arch_id):
        return specs.setdefault(arch_id, _tiny(arch_id))

    monkeypatch.setattr(launcher, "get_arch", get_arch)
    # the loop's default monitor reads the wall clock; give it a fake one
    ticks = itertools.count()
    real = launcher.StragglerMonitor
    monkeypatch.setattr(launcher, "StragglerMonitor",
                        lambda: real(clock=lambda: float(next(ticks))))
    return get_arch


def _args(arch, ckpt, steps, *extra):
    return ["--arch", arch, "--shape", "train_batch", "--steps", str(steps),
            "--ckpt", str(ckpt), "--device", "cpu", *extra]


@pytest.mark.parametrize("arch", ["xdeepfm", "autoint", "bst",
                                  "two-tower-retrieval"])
def test_launcher_checkpoints_and_resumes(tiny, tmp_path, arch):
    p2, s2, h2 = launcher.main(_args(arch, tmp_path, 2))
    assert len(h2) == 2 and int(s2.step) == 2
    assert checkpoint.latest_step(str(tmp_path)) == 2
    p3, s3, h3 = launcher.main(_args(arch, tmp_path, 3, "--resume"))
    assert len(h3) == 1 and int(s3.step) == 3
    assert checkpoint.latest_step(str(tmp_path)) == 3
    # an uninterrupted run of 3 steps reaches the same state
    pf, sf, hf = launcher.main(_args(arch, tmp_path / "straight", 3))
    assert hf == h2 + h3
    for a, b in zip(leaves(params_to_numpy(p3)),
                    leaves(params_to_numpy(pf))):
        assert np.array_equal(a, b)


def test_launcher_from_zeros_matches_reference_steps(tiny, tmp_path):
    """Two launcher steps of tiny xDeepFM from zeros against the
    reference's train step (``launch/steps._train_step``: AdamW(lr=3e-4,
    weight_decay=0.01) after ``jax.value_and_grad``) from zeros on the
    same two batches; only ``lin_table``, ``dense_w`` and the last DNN
    bias leave zero."""
    spec = tiny("xdeepfm")
    params, _, hist = launcher.main(_args("xdeepfm", tmp_path, 2))
    cfg = spec.config
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
        lambda: jrec.init_params(jax.random.PRNGKey(0), cfg)))
    opt = JAdamW(lr=3e-4, weight_decay=0.01)
    js = opt.init(jp)
    stream = JCTRStream(cfg, BATCH, seed=0)
    jhist = []
    for i in range(2):
        b = {k: jnp.asarray(v) for k, v in stream(i).items()}
        loss, g = jax.value_and_grad(lambda p: jrec.loss(p, b, cfg))(jp)
        jp, js = opt.update(g, js, jp)
        jhist.append(float(loss))
    assert np.allclose(hist, jhist, rtol=0, atol=1e-6)
    got = params_to_numpy(params)
    moved = set()
    for (path, want), a in zip(jax.tree_util.tree_leaves_with_path(jp),
                               leaves(got)):
        assert np.abs(a - np.asarray(want)).max() <= 1e-6
        if np.any(a != 0):
            moved.add(jax.tree_util.keystr(path))
    n = len(cfg.mlp_dims)
    assert moved == {"['dense_w']", "['lin_table']", f"['dnn'][{n}]['b']"}


@pytest.mark.parametrize("flag", ["--multi-pod", "--debug-mesh"])
def test_mesh_options_exit_with_a_message(tiny, tmp_path, flag):
    """The port has the reference's meshes now (``launch.mesh``), but its
    launcher trains on one rank: a multi-rank mesh flag exits."""
    with pytest.raises(SystemExit, match="multi-rank mesh"):
        launcher.main(_args("xdeepfm", tmp_path, 1, flag))


def test_lm_family_exits_with_a_message(tmp_path):
    """The lm family trains; a prefill or decode shape is not a train
    shape, and the launcher says so."""
    with pytest.raises(SystemExit, match="not a train shape"):
        launcher.main(["--arch", "gemma3-1b", "--shape", "prefill_32k",
                       "--steps", "1", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["gemma3-1b", "olmoe-1b-7b"])
def test_lm_launcher_from_zeros_matches_reference_steps(tiny, tmp_path,
                                                        arch):
    """Two launcher steps of a tiny LM from zeros against the reference's
    train step (AdamW(lr=3e-4, weight_decay=0.01) after
    ``jax.value_and_grad`` of ``lm_loss``) from zeros on the same
    ``TokenPipeline`` batches, within 1e-6."""
    spec = tiny(arch)
    params, opt_state, hist = launcher.main(
        ["--arch", arch, "--shape", "train_4k", "--steps", "2", "--ckpt",
         str(tmp_path), "--device", "cpu"])
    jcfg = reduced_spec(arch).config
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jlm.param_structs(jcfg))
    opt = JAdamW(lr=3e-4, weight_decay=0.01)
    js = opt.init(jp)
    pipe = JTokenPipeline(jcfg.vocab_size, 4, 16, seed=0)
    loss_and_grad = jax.jit(jax.value_and_grad(
        lambda p, t: jlm.lm_loss(p, t, jcfg)))
    jhist = []
    for i in range(2):
        loss, g = loss_and_grad(jp, jnp.asarray(pipe(i)["tokens"]))
        jp, js = opt.update(g, js, jp)
        jhist.append(float(loss))
    assert np.allclose(hist, jhist, rtol=0, atol=1e-6)
    # every logit is 0; from a zero router the tied top-k sends every
    # token to the first k experts, an aux loss of exactly 1
    moe = spec.config.moe
    start = np.log(spec.config.vocab_size) + (moe.aux_loss_weight if moe
                                              else 0.0)
    assert abs(hist[0] - start) <= 1e-5 and hist[1] == hist[0]
    assert int(opt_state.step) == 2
    for a, want in zip(leaves(params_to_numpy(params)), jax.tree.leaves(jp)):
        assert np.abs(a - np.asarray(want, np.float32)).max() <= 1e-6


def test_the_card_is_the_default_device(tiny):
    assert launcher.parser().parse_args(["--arch", "x"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launcher.main(["--arch", "xdeepfm", "--shape", "train_batch",
                           "--steps", "1"])


def test_make_batches_moves_the_stream_to_the_device(tiny):
    spec = tiny("two-tower-retrieval")
    b = launcher.make_batches(spec, spec.shape("train_batch"), "cpu")(4)
    assert set(b) == {"user_id", "user_fields", "item_id", "item_fields",
                      "label"}
    assert all(isinstance(v, torch.Tensor) for v in b.values())
    with pytest.raises(ValueError, match="no training pipeline"):
        launcher.make_batches(dataclasses.replace(spec, family="gnn"),
                              spec.shape("train_batch"))
