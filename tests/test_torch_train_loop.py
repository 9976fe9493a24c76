"""The port's ``Trainer``, checkpoints, training launcher and
``examples/torch_train_moe.py`` against the JAX reference on the CPU in
float32, with the same weights: per-step losses and metrics over 5
steps within 1e-4 relative; a checkpoint directory written by the
reference restored by the port (same leaves, bit for bit) and the next
step equal to the reference's; ``_prune`` and ``latest_step`` as the
reference's; the manifest the port writes equal to the reference's for
the same tree. The launcher and the example print the reference's lines
(the wall-clock seconds removed), with the reference's own launcher and
example run on the same weights (``Model.init`` patched in both
packages, ``get_config`` / ``ModelConfig`` to float32)."""
import dataclasses
import functools
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.models.transformer import Model as JaxModel
from repro.train import AdamWConfig as JaxAdamW
from repro.train import DataConfig as JaxData
from repro.train import TrainConfig as JaxTrain
from repro.train import Trainer as JaxTrainer
from repro.train import checkpoint as jax_ckpt
from repro.train import train_loop as jax_train_loop
from repro.train import init_adamw as jax_init_adamw
import repro_torch.configs as torch_configs
from repro_torch.launch import train as torch_launch
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from repro_torch.train import AdamWConfig, DataConfig, TrainConfig, Trainer
from repro_torch.train import checkpoint as torch_ckpt
from repro_torch.train import init_adamw
from repro_torch.train.train_loop import train_step
from torch_parity import auto_ctx, one_thread, reference, to_np  # noqa: F401

BAR = 1e-4
ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=5)
DATA = dict(seq_len=64, global_batch=2)


def trainers(config: str, steps: int = 5, ckpt_dir=None, dtype="float32"):
    """(reference Trainer, port Trainer) on the same seed-0 weights."""
    jcfg, _, jparams, tcfg, tparams = reference(dtype, config=config)
    jt = JaxTrainer(jcfg, JaxTrain(steps=steps, log_every=1,
                                   ckpt_dir=ckpt_dir, opt=JaxAdamW(**OPT),
                                   data=JaxData(**DATA)), ctx=auto_ctx())
    jt.params = jax.tree.map(jnp.copy, jparams)   # the step donates them
    jt.opt_state = jax_init_adamw(jt.params)
    tt = Trainer(tcfg, TrainConfig(steps=steps, log_every=1,
                                   opt=AdamWConfig(**OPT),
                                   data=DataConfig(**DATA)), device="cpu")
    tt.params = tparams
    tt.opt_state = init_adamw(tparams)
    return jt, tt


def rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("config", ["internlm2", "deepseek-v3"])
def test_trainer_history_matches_reference(config):
    jt, tt = trainers(config)
    want, got = jt.run(), tt.run()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        assert set(g) == set(w)
        for k in w:
            if k not in ("step", "wall_s"):
                assert rel(g[k], w[k]) <= BAR, (g["step"], k, g[k], w[k])
    assert got[-1]["loss"] < got[0]["loss"]


def test_port_restores_a_reference_checkpoint(tmp_path):
    """The reference trains 2 steps and saves; the port's ``Trainer``
    restores that directory (leaves bit-identical, the step, int32 and
    float32 dtypes) and takes the third step on the batch the reference
    takes it on: loss, metrics and every parameter within the bar."""
    d = str(tmp_path / "ckpt")
    jt, tt = trainers("deepseek-v3", steps=2, ckpt_dir=d)
    jt.run()
    tt.tcfg.ckpt_dir = d
    tt.maybe_restore()
    assert tt.step == 2 and int(tt.opt_state.step) == 2
    want = flatten(jax.tree.map(np.asarray, (jt.params, jt.opt_state.m)))
    got = flatten((tt.params, tt.opt_state.m))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(to_np(got[k]), want[k], err_msg=k)
    tokens, labels, mask = jt.loader.next_batch()
    jp, js, jm = jt._step(jt.params, jt.opt_state, jnp.asarray(tokens),
                          jnp.asarray(labels), jnp.asarray(mask))
    tp, ts, tm = train_step(tt.model, tt.tcfg.opt, tt.params, tt.opt_state,
                            torch.as_tensor(tokens).long(),
                            torch.as_tensor(labels).long(),
                            loss_mask=torch.as_tensor(mask))
    for k in jm:
        assert rel(float(tm[k]), float(jm[k])) <= BAR, k
    want = flatten(jax.tree.map(np.asarray, jp))
    for k, v in flatten(tp).items():
        err = np.max(np.abs(to_np(v) - want[k]))
        assert err <= BAR * max(np.max(np.abs(want[k])), 1e-6), k


def test_step_functions_match_reference():
    """``launch/steps.py``: ``make_train_step`` on a batch with memory
    (the encoder-decoder: its frames) against the reference's, its
    metrics within the bar (the loss, the gradient norm; a first AdamW
    step moves each weight by about ±lr, whatever the size of its
    gradient, so the weights are compared after the Trainer's steps
    instead); ``make_prefill_step`` and
    ``make_serve_step`` are ``Model.prefill`` and ``Model.decode_step``."""
    from repro.launch import steps as jax_steps
    from repro_torch.launch import steps as torch_steps
    from torch_parity import memory

    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config="seamless")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    mem = memory(jcfg, 2, seed=6)
    jstep = jax.jit(jax_steps.make_train_step(jmodel, JaxAdamW(**OPT)))
    _, _, jm = jstep(jparams, jax_init_adamw(jparams),
                      {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                       "memory": mem})
    model = Model(tcfg)
    _, ts, tm = torch_steps.make_train_step(model, AdamWConfig(**OPT))(
        tparams, init_adamw(tparams),
        {"tokens": torch.as_tensor(toks[:, :-1]).long(),
         "labels": torch.as_tensor(toks[:, 1:]).long(),
         "memory": torch.as_tensor(mem)})
    assert set(tm) == set(jm) and int(ts.step) == 1
    for k in jm:
        assert rel(float(tm[k]), float(jm[k])) <= BAR, k
    t = torch.as_tensor(toks[:, :8]).long()
    m = torch.as_tensor(mem)
    got, cache = torch_steps.make_prefill_step(model)(tparams, t, m)
    np.testing.assert_array_equal(got, model.prefill(tparams, t,
                                                     memory=m)[0])
    pos = torch.full((2,), 8, dtype=torch.int32)
    nxt = got.argmax(-1)[:, None]
    want_logits, _ = model.decode_step(
        tparams, model.prefill(tparams, t, memory=m)[1], nxt, pos)
    got_logits, _ = torch_steps.make_serve_step(model)(tparams, cache, nxt,
                                                       pos)
    np.testing.assert_array_equal(got_logits, want_logits)


def _tree(pkg: str):
    """The same bf16/f32/int32 (params, AdamWState)-shaped tree in each
    package."""
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "prefix": ({"a": rng.standard_normal(5).astype(np.float32)},)}
    if pkg == "jax":
        params = {"w": jnp.asarray(p["w"], jnp.bfloat16),
                  "prefix": ({"a": jnp.asarray(p["prefix"][0]["a"])},)}
        st = jax_init_adamw(params)
        return (params, st._replace(step=jnp.int32(4)))
    params = {"w": torch.tensor(p["w"]).bfloat16(),
              "prefix": ({"a": torch.tensor(p["prefix"][0]["a"])},)}
    st = init_adamw(params)
    return (params, st._replace(step=torch.tensor(4, dtype=torch.int32)))


def test_checkpoint_layout_equals_reference(tmp_path):
    """For the same tree both packages write the same manifest (paths,
    shapes, dtypes, the treedef text) and the same ``leaves.npz``; the
    port restores both directories to the same leaves and structure."""
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_ckpt.save_checkpoint(jd, 4, _tree("jax"))
    torch_ckpt.save_checkpoint(td, 4, _tree("torch"))
    step_dir = "step_00000004"
    jm, tm = (json.loads(Path(d, step_dir, "manifest.json").read_text())
              for d in (jd, td))
    assert tm == jm
    with np.load(Path(jd, step_dir, "leaves.npz")) as a, \
            np.load(Path(td, step_dir, "leaves.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype
            np.testing.assert_array_equal(a[f], b[f])
    assert sorted(os.listdir(Path(td, step_dir))) == [
        "leaves.npz", "manifest.json"]          # no treedef.pkl
    for d in (jd, td):
        step, (params, st) = torch_ckpt.restore_checkpoint(d, device="cpu")
        assert step == 4 and type(st).__name__ == "AdamWState"
        assert params["w"].dtype == torch.bfloat16
        assert st.step.dtype == torch.int32 and int(st.step) == 4
        assert isinstance(params["prefix"], tuple)
        want = dict(torch_ckpt._flatten(_tree("torch")))
        got = dict(torch_ckpt._flatten((params, st)))
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.dtype == want[k].dtype, k
            np.testing.assert_array_equal(to_np(v), to_np(want[k]),
                                          err_msg=k)


def test_prune_and_latest_step_match_reference(tmp_path):
    dirs = {}
    for name, mod, tree in (("jax", jax_ckpt, {"x": jnp.zeros(1)}),
                            ("torch", torch_ckpt, {"x": torch.zeros(1)})):
        d = tmp_path / name
        assert mod.latest_step(str(d)) is None
        d.mkdir()
        assert mod.latest_step(str(d)) is None
        for s in (0, 3, 1, 5, 2, 4):
            mod.save_checkpoint(str(d), s, tree, keep=3)
        (d / "notes.txt").write_text("kept")
        mod._prune(str(d), 2)
        dirs[name] = (sorted(os.listdir(d)), mod.latest_step(str(d)))
    assert dirs["torch"] == dirs["jax"] == (
        ["notes.txt", "step_00000004", "step_00000005"], 5)
    with pytest.raises(FileNotFoundError):
        torch_ckpt.restore_checkpoint(str(tmp_path / "none"), device="cpu")


_WALL = re.compile(r"\s+\d+(\.\d+)?s$")


def _lines(text: str) -> list:
    return [_WALL.sub("", ln) for ln in text.splitlines()]


def _same_weights(monkeypatch, dtype="float32"):
    """Both packages' ``Model.init`` give the reference's init of the
    model's own config, in ``dtype``."""
    jax_init = JaxModel.init
    made = {}

    def jinit(self, key):
        params = jax_init(self, key)
        # a copy: the reference's step donates its params
        made["jax"] = jax.tree.map(lambda a: np.array(a, copy=True), params)
        return params

    def tinit(self, seed=0, *, device="cuda"):
        return from_jax_params(made["jax"], self.cfg, device)
    monkeypatch.setattr(JaxModel, "init", jinit)
    monkeypatch.setattr(Model, "init", tinit)


def test_launcher_prints_reference_lines(monkeypatch, capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu`` against
    the reference's launcher (on its own smoke mesh) at the same
    arguments and weights."""
    _same_weights(monkeypatch)
    for mod in (jax_configs, torch_launch):
        real = mod.get_config
        monkeypatch.setattr(mod, "get_config", functools.partial(
            lambda name, real: dataclasses.replace(real(name),
                                                   dtype="float32"),
            real=real))
    args = ["--smoke", "--steps", "4", "--seq-len", "64", "--batch", "2",
            "--log-every", "2"]
    from repro.launch import train as jax_launch
    monkeypatch.setattr(sys, "argv", ["train", *args])
    jax_launch.main()
    want = capsys.readouterr().out
    torch_launch.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out
    assert len(_lines(want)) == 2
    assert _lines(got) == _lines(want)


def _example(path: str):
    spec = importlib.util.spec_from_file_location(Path(path).stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_moe_example_prints_reference_lines(monkeypatch, capsys,
                                                  tmp_path):
    """``examples/torch_train_moe.py`` against ``examples/train_moe.py``,
    3 steps of 2 × 32 tokens (one log row, at the last step), float32. The
    reference's MoE layer raises on its Explicit-axis smoke mesh: its
    ``Trainer`` gets the Auto-axis one."""
    _same_weights(monkeypatch)
    monkeypatch.setattr(jax_train_loop, "make_smoke_ctx", auto_ctx)
    for mod in (jax_configs, torch_configs):
        monkeypatch.setattr(mod, "ModelConfig", functools.partial(
            mod.ModelConfig, dtype="float32"))
    args = ["--steps", "3", "--seq-len", "32", "--batch", "2"]
    ref = _example(str(ROOT / "examples" / "train_moe.py"))
    monkeypatch.setattr(sys, "argv", ["train_moe.py", *args, "--ckpt-dir",
                                      str(tmp_path / "ckpt")])
    ref.main()
    want = capsys.readouterr().out
    port = _example(str(ROOT / "examples" / "torch_train_moe.py"))
    port.main([*args, "--ckpt-dir", str(tmp_path / "ckpt_port"),
               "--device", "cpu"])
    got = capsys.readouterr().out.replace("ckpt_port", "ckpt")
    assert len(_lines(want)) == 4, want
    assert _lines(got) == _lines(want)
    assert sorted(os.listdir(tmp_path / "ckpt_port")) == ["step_00000003"]
