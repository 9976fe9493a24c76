"""Training loop: the step (forward, backward, AdamW), the data pipeline,
checkpoints and metrics — the reference's ``Trainer`` in eager PyTorch,
on one device (the card unless ``device="cpu"``) or, given ``ctx=``, on
a mesh (one process per rank): each rank holds its blocks of the
parameters and of AdamW's moments under the model's specs
(``launch/sharding.param_pspecs``, the reference's default rules), takes
its rows of the loader's global batch, and sums each leaf's gradient
over the axes that replicate it (``Model.reduce_grads``)."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (resolve_device, tree_leaves,
                                       tree_unflatten_like)
from repro_torch.launch.sharding import PSpec
from repro_torch.models.transformer import Model, build_model
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.data import DataConfig, PackedLoader
from repro_torch.train.optimizer import (AdamWConfig, AdamWState,
                                        adamw_update, init_adamw)

PyTree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = only at the end
    ckpt_dir: Optional[str] = None
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    seed: int = 0


def grads_of(model: Model, loss: torch.Tensor, leaves: list, like: PyTree,
             specs: PyTree = None) -> PyTree:
    """The gradient of ``loss`` (a value every rank holds alike) in
    ``leaves`` (the leaves of ``like``, whose specs are ``specs``;
    default the model's), in ``like``'s tree and dtypes: zeros for a
    leaf the loss does not reach, as JAX's. On a mesh: seeded ``1 / n``
    on each of the ``n`` ranks of ``model.train_axes()``, then
    ``model.reduce_grads``."""
    n = 1
    for a in model.train_axes() if model.sharded else ():
        n *= model.ctx.axis_size(a)
    seed = None if n == 1 else torch.full_like(loss, 1.0 / n)
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                allow_unused=True, materialize_grads=True)
    return model.reduce_grads(tree_unflatten_like(like, grads), specs)


def loss_and_grads(model: Model, params: PyTree, tokens, labels, *,
                   memory=None, loss_mask=None):
    """→ ((loss, metrics), grads): ``Model.forward_train`` and the
    gradient of its loss in every parameter (:func:`grads_of`). The
    metrics are detached. On a mesh ``params`` and ``grads`` are this
    rank's blocks; the inputs, the loss and the metrics global."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten_like(params, leaves)
    loss, metrics = model.forward_train(p, tokens, labels, memory=memory,
                                        loss_mask=loss_mask)
    grads = grads_of(model, loss, leaves, params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def train_step(model: Model, opt_cfg: AdamWConfig, params, opt_state,
               tokens, labels, *, memory=None, loss_mask=None):
    """One update: → (params, opt_state, metrics) with ``loss``,
    ``grad_norm`` and ``lr`` added to the model's metrics and
    ``expert_counts`` dropped, as the reference's jitted step."""
    (loss, metrics), grads = loss_and_grads(
        model, params, tokens, labels, memory=memory, loss_mask=loss_mask)
    params, opt_state, om = adamw_update(
        opt_cfg, params, grads, opt_state,
        *((model.ctx, model.specs) if model.sharded else ()))
    metrics = {k: v for k, v in metrics.items() if k != "expert_counts"}
    metrics.update(loss=loss, **om)
    return params, opt_state, metrics


class Trainer:
    """``params`` and ``opt_state`` are public, as in the reference:
    callers may set them (on a mesh, as this rank's blocks). ``Model.init``
    draws the port's own random weights from ``tcfg.seed`` (the
    reference's distributions, not its draws). The data loader is not
    part of a checkpoint, in either package: a restored trainer reads the
    corpus from its start. ``ctx``: the mesh (default: one device, the
    reference's smoke context); the model is ``build_model(cfg, ctx)``.
    On a mesh a checkpoint holds the global leaves, written once."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, ctx=None,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.ctx = ctx
        self.model = Model(cfg) if ctx is None else build_model(cfg, ctx)
        self.loader = PackedLoader(tcfg.data)
        self.params = self.model.init(tcfg.seed, device=self.device)
        self.opt_state = init_adamw(self.params)
        self.step = 0
        self.history: List[Dict[str, float]] = []

    def _ckpt_layout(self) -> dict:
        """``ctx`` and the specs of (params, opt_state) on a mesh."""
        if not self.model.sharded:
            return {}
        sp = self.model.specs
        return {"ctx": self.model.ctx,
                "specs": (sp, AdamWState(step=PSpec(), m=sp, v=sp))}

    def _save(self) -> None:
        save_checkpoint(self.tcfg.ckpt_dir, self.step,
                        (self.params, self.opt_state),
                        **self._ckpt_layout())

    def maybe_restore(self) -> None:
        d = self.tcfg.ckpt_dir
        if not d:
            return
        try:
            self.step, tree = restore_checkpoint(d, device=self.device,
                                                 **self._ckpt_layout())
            self.params, self.opt_state = tree
        except FileNotFoundError:
            pass

    def run(self, on_log: Optional[Callable[[Dict], None]] = None)\
            -> List[Dict[str, float]]:
        t0 = time.monotonic()
        while self.step < self.tcfg.steps:
            tokens, labels, mask = (torch.as_tensor(a).to(self.device)
                                    for a in self.loader.next_batch())
            self.params, self.opt_state, metrics = train_step(
                self.model, self.tcfg.opt, self.params, self.opt_state,
                tokens.long(), labels.long(), loss_mask=mask)
            self.step += 1
            if (self.step % self.tcfg.log_every == 0
                    or self.step == self.tcfg.steps):
                row = {k: float(v) for k, v in metrics.items()}
                row["step"] = self.step
                row["wall_s"] = time.monotonic() - t0
                self.history.append(row)
                if on_log:
                    on_log(row)
            if (self.tcfg.ckpt_dir and self.tcfg.ckpt_every
                    and self.step % self.tcfg.ckpt_every == 0):
                self._save()
        if self.tcfg.ckpt_dir:
            self._save()
        return self.history
