"""Training on meshes over gloo ranks, in float32, against the
reference's ``jax.value_and_grad(forward_train)`` on the same meshes.

* ``deepseek-moe-16b-smoke`` (the all-to-all MoE where the experts and
  the sequence divide the model axis, the gather with experts replicated
  where they do not), the smoke DeepSeek-V3 (MLA, dense prefix layers,
  MoE) and the smoke InternLM2 (GQA, dense) on (2,1), (1,2) and (2,2),
  each rank holding its blocks of the weights: the loss, every metric
  and every leaf's gradient (gathered to global) within 1e-4 relative of
  the reference's, the same loss on every rank; one AdamW update's
  ``grad_norm``, ``lr`` and moments within 1e-4 (2e-4 for ``v``).
* (4,2): the MoE smoke model within 1e-4 of the reference on that mesh,
  and the reference's own bar (``tests/test_multidevice.py``): the loss
  within 0.02 relative of one device.
"""
from __future__ import annotations

import numpy as np
import pytest

import torch_mesh_train as T
from torch_mesh import rel_err

CONFIGS = {"moe": ("deepseek-moe-16b-smoke", {}),
           "deepseek-v3": ("deepseek-v3-671b-smoke", {}),
           "internlm2": ("internlm2-1.8b-smoke", {})}
MESHES_OF = {"moe": ["2x1", "1x2", "2x2", "4x2"],
             "deepseek-v3": ["2x1", "1x2", "2x2"],
             "internlm2": ["2x1", "1x2", "2x2"]}


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return T.run(tmp_path_factory, "test_torch_sharded_train",
                 EXTRA_REFERENCE)


@pytest.mark.parametrize("name,mesh", [(n, m) for n in CONFIGS
                                       for m in MESHES_OF[n]])
def test_loss_and_gradients_match_reference_on_mesh(both, name, mesh):
    want, got = both
    T.check_case(want, got, f"{name}/{mesh}")


# ---------------------------------------------------------------------------
# the trainer, checkpoints, remat and MTPTrainer on a mesh
# ---------------------------------------------------------------------------
#: the MTP head's configuration: a second head, as the reference's own
#: ``MTPTrainer`` test trains
EXTRA_CONFIGS = {"mtp": ("deepseek-v3-671b-smoke", {"mtp_num_layers": 2})}
STEPS, MTP_STEPS, MTP_LR = 3, 2, 1e-2
HIST = ("loss", "nll", "grad_norm", "lr", "moe_lb_loss", "moe_z_loss",
        "tokens")


def train_config(TrainConfig, DataConfig, AdamWConfig, ckpt_dir=None):
    return TrainConfig(steps=STEPS, log_every=1, ckpt_dir=ckpt_dir,
                       opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=STEPS),
                       data=DataConfig(seq_len=T.S, global_batch=T.B))


EXTRA_REFERENCE = """
from repro.serving.mtp import MTPTrainer
from repro.train.data import DataConfig
from repro.train.train_loop import TrainConfig, Trainer
from test_torch_sharded_train import (EXTRA_CONFIGS, HIST, MTP_LR,
                                      MTP_STEPS, train_config)
cfg = config(get_config, mod.CONFIGS, "moe")
tr = Trainer(cfg, train_config(TrainConfig, DataConfig, AdamWConfig),
             ctx=ctx_of((2, 2)))
tr.params = jax.tree.map(jnp.copy, weights["moe"])
tr.opt_state = init_adamw(tr.params)
hist = tr.run()
for k in HIST:
    put("trainer/" + k, np.asarray([row[k] for row in hist]))
cfg = config(get_config, EXTRA_CONFIGS, "mtp")
toks = jnp.asarray(inputs(cfg)[0])
mt = MTPTrainer(build_model(cfg, ctx_of((1, 2))),
                jax.tree.map(jnp.copy, weights["mtp"]), 1, lr=MTP_LR)
put("mtp/loss", np.asarray([mt.train_step(toks)
                            for _ in range(MTP_STEPS)]))
tree_put("mtp/head/", mt.params["mtp"][1])
"""


def extra_rank(rank, ctx_of, flat):
    import os
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params
    from repro_torch.serving.mtp import MTPTrainer
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.data import DataConfig
    from repro_torch.train.optimizer import AdamWConfig, init_adamw
    from repro_torch.train.train_loop import (TrainConfig, Trainer,
                                              loss_and_grads)

    out = {}
    cfg = T.config(get_config, CONFIGS, "moe")
    toks, labels = (torch.from_numpy(a).long() for a in T.inputs(cfg)[:2])
    # the reference's own bar: (4,2) against one device
    loss1, _ = Model(cfg).forward_train(
        from_jax_params(flat["moe"], cfg, "cpu"), toks, labels)
    out["moe/one_device/loss"] = float(loss1)
    # Trainer(ctx=) on (2,2), its checkpoint restored on one device
    ctx = ctx_of((2, 2))
    root = os.path.join(tempfile.gettempdir(),
                        f"sharded-train-{os.getppid()}-{rank // 4}")
    tr = Trainer(cfg, train_config(TrainConfig, DataConfig, AdamWConfig,
                                   os.path.join(root, "mesh")),
                 ctx=ctx, device="cpu")
    tr.params = from_jax_params(flat["moe"], cfg, "cpu", ctx=ctx)
    tr.opt_state = init_adamw(tr.params)
    hist = tr.run()
    for k in HIST:
        out["trainer/" + k] = np.asarray([row[k] for row in hist])
    step, (p1, o1) = ck.restore_checkpoint(os.path.join(root, "mesh"),
                                           device="cpu")
    whole = T.global_tree(tr.model, tr.params)
    out["ckpt/to_one"] = (step == STEPS and all(
        np.array_equal(whole[T.path_name(k)], t.numpy())
        for k, t in shd.leaves_by_path(p1).items()) and all(
        np.array_equal(T.global_tree(tr.model, tr.opt_state.m)[
            T.path_name(k)], t.numpy())
        for k, t in shd.leaves_by_path(o1.m).items()))
    # a one-device checkpoint restored on (2,2): each rank's blocks
    mine = os.path.join(root, f"one{rank}")
    ck.save_checkpoint(mine, 7, (p1, o1))
    sp = tr.model.specs
    step, (p2, o2) = ck.restore_checkpoint(
        mine, device="cpu", ctx=ctx,
        specs=(sp, o1._replace(step=shd.PSpec(), m=sp, v=sp)))
    out["ckpt/to_mesh"] = (step == 7 and all(
        torch.equal(a, b) for a, b in zip(
            shd.leaves_by_path(p2).values(),
            shd.leaves_by_path(shd.shard_tree(p1, sp, ctx)).values())))
    shutil.rmtree(mine)
    if rank % 4 == 0:
        shutil.rmtree(os.path.join(root, "mesh"))
    # remat="full" on (2,2): the same loss and gradients, the forward's
    # collectives issued again in backward
    params = from_jax_params(flat["moe"], cfg, "cpu", ctx=ctx)
    got = {}
    for remat in ("none", "full"):
        m = Model(cfg, ctx=ctx_of((2, 2), remat=remat), remat=remat)
        ctx.comm.sent.clear()
        (loss, _), g = loss_and_grads(m, params, toks, labels)
        got[remat] = (float(loss), T.global_tree(m, g),
                      dict(ctx.comm.sent))
    out["remat/equal"] = (got["none"][0] == got["full"][0] and all(
        np.array_equal(got["none"][1][k], got["full"][1][k])
        for k in got["none"][1]))
    out["remat/sent"] = {k: got[k][2] for k in got}
    # MTPTrainer on (1,2)
    mcfg = T.config(get_config, EXTRA_CONFIGS, "mtp")
    ctx = ctx_of((1, 2))
    m = Model(mcfg, ctx=ctx)
    mt = MTPTrainer(m, from_jax_params(flat["mtp"], mcfg, "cpu", ctx=ctx),
                    1, lr=MTP_LR)
    mtoks = torch.from_numpy(T.inputs(mcfg)[0]).long()
    out["mtp/loss"] = np.asarray([mt.train_step(mtoks)
                                  for _ in range(MTP_STEPS)])
    head = T.global_tree(m, mt.params)
    out.update({"mtp/head/" + k[len("mtp.1."):]: v for k, v in head.items()
                if k.startswith("mtp.1.")})
    return out


def test_4x2_loss_within_the_reference_bar_of_one_device(both):
    _, got = both
    one = got[0]["moe/one_device/loss"]
    for g in got:
        assert abs(g["moe/4x2/loss"] - one) / abs(one) < 0.02


def test_trainer_on_mesh_matches_reference_history(both):
    want, got = both
    for k in HIST:
        w = want["trainer/" + k]
        assert len(w) == STEPS
        for g in got:
            assert rel_err(g["trainer/" + k], w) < 1e-4, k


def test_checkpoint_moves_between_a_mesh_and_one_device(both):
    _, got = both
    for g in got:
        assert g["ckpt/to_one"] is True
        assert g["ckpt/to_mesh"] is True


def test_remat_full_on_mesh_recomputes_its_collectives(both):
    _, got = both
    for g in got:
        assert g["remat/equal"] is True
        none, full = g["remat/sent"]["none"], g["remat/sent"]["full"]
        # the backward's own traffic is the same; the recomputed forward
        # moves the superblocks' forward bytes again
        for k in none:
            if k.endswith(".bwd") or k == "grad_sum":
                assert full[k] == none[k], k
        assert full["all_gather"] > none["all_gather"]
        assert {"psum.bwd", "all_gather.bwd", "all_to_all.bwd",
                "grad_sum"} <= set(none)


def test_mtp_trainer_on_mesh_matches_reference(both):
    want, got = both
    for g in got:
        assert rel_err(g["mtp/loss"], want["mtp/loss"]) < 1e-4
    leaves = [k for k in want if k.startswith("mtp/head/")]
    assert leaves
    for k in leaves:
        assert rel_err(got[0][k], want[k]) < 1e-4, k
