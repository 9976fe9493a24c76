"""Dry-run machinery: every (arch × input shape × mesh) combination's
step, run on ``meta`` tensors as rank 0 of the production mesh.

The reference lowers and compiles each combination's jitted step for
512 fake host devices and reads XLA's analyses. The port has no
compiler to ask, so it runs the step itself, on shapes: the model is
built for rank 0 of a shape-only 16×16 or 2×16×16 mesh
(``models/mesh_ctx.Comm(shape_only=True)``: each collective returns a
stand-in of its result's shape and counts the bytes it would send), the
parameters come from a shape-only init (``Model.init(device="meta")``:
this rank's blocks under ``launch/sharding.py``'s rules), and the train
step (forward, backward, AdamW), the prefill or the decode step runs on
them as on a card, every shape checked by PyTorch's meta kernels (the
kernels' entry points take their plain versions for ``meta`` tensors
inside ``kernels.runtime.shapes_only``).

A record keeps the reference's keys where the port has a value:

  * ``lower_s`` is the seconds the ``meta`` run took;
  * ``memory_analysis`` holds the per-device bytes from the specs in
    place of XLA's ``memory_analysis``: parameters, AdamW's ``m`` / ``v``
    and step, the decode cache and the inputs, each this rank's block
    (``argument_bytes`` their sum, ``peak_bytes_estimate`` the same:
    activations are not counted);
  * ``roofline``: :class:`~repro_torch.roofline.analysis.RooflineTerms`
    at the H100's bounds, with ``flops`` and ``model_flops`` from
    ``analytic_model_flops`` (per device: over ``n_devices``), HBM bytes
    the arguments' (each read once) and collective bytes the ``meta``
    run's, by the reference's op kinds (``comm_sent`` keeps the port's
    own keys, the backward's apart).

``compile_s``, ``hlo_bytes``, ``cost_analysis_raw`` and ``hlo`` are
absent: nothing is compiled and PyTorch produces no HLO. A combination
whose step stops on ``meta`` (an op whose result's shape depends on
values) is recorded ``ok: false`` with its error, as the reference
records a failed compile.
"""
from __future__ import annotations

import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.kernels import runtime
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (derive_ctx, input_shardings,
                                      input_specs, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.models.mesh_ctx import Comm, MeshShape
from repro_torch.models.transformer import build_model
from repro_torch.roofline.analysis import RooflineTerms, analytic_model_flops
from repro_torch.train.optimizer import init_adamw

#: the port's collective keys → the reference's HLO op kinds
COLLECTIVE_KIND = {
    "psum": "all-reduce", "pmax": "all-reduce", "psum.bwd": "all-reduce",
    "grad_sum": "all-reduce", "all_gather": "all-gather",
    "all_gather.bwd": "reduce-scatter", "all_to_all": "all-to-all",
    "all_to_all.bwd": "all-to-all", "ppermute": "collective-permute",
    "ppermute.bwd": "collective-permute"}


def dry_mesh(multi_pod: bool) -> MeshShape:
    """The production mesh as rank 0 holds it, with a shape-only
    ``Comm``."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    comm = Comm(dict(mesh.shape), 0, "meta", shape_only=True)
    return MeshShape(tuple(mesh.shape.values()), mesh.axis_names, comm=comm)


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (``meta`` ones included)."""
    return sum(t.numel() * t.element_size()
               for t in shd.leaves_by_path(tree).values()
               if isinstance(t, torch.Tensor))


def local_inputs(tree, specs, ctx):
    """``meta`` stand-ins of this rank's blocks of ``tree`` under
    ``specs``."""
    return shd.spec_tree_map(
        lambda t, sp: torch.empty(shd.local_shape(t.shape, sp, ctx),
                                  dtype=t.dtype, device="meta"),
        tree, specs)


def _decode_cache(model, batch: int, max_len: int):
    """The decode cache in its decode layout, this rank's block."""
    full = model.cache_spec(batch, max_len)
    return local_inputs(full, model._layout_specs(full, True), model.ctx)


def run_one(arch: str, shape_name: str, multi_pod: bool,
            ctx_overrides: Optional[dict] = None,
            sharding_profile: str = "default") -> Dict[str, Any]:
    """Run one combination's step on ``meta`` tensors; return its record.

    sharding_profile: "default" or "decode_opt" (replicate weights over
    data at decode, EP across both axes), as the reference's."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    mesh = dry_mesh(multi_pod)
    overrides = dict(ctx_overrides or {})
    param_rules = None
    if sharding_profile == "decode_opt":
        param_rules = shd.DECODE_RULES
        total = mesh.shape["data"] * mesh.shape["model"]
        if cfg.has_moe and cfg.moe.num_experts % total == 0:
            overrides.setdefault("ep_axis", ("data", "model"))
    ctx = derive_ctx(mesh, shape, cfg, multi_pod, **overrides)
    long_context = shape_name == "long_500k"
    model = build_model(cfg, ctx, long_context=long_context,
                        rules=param_rules)

    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "sharding_profile": sharding_profile,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size,
        "batch_axes": list(ctx.batch_axes),
        "moe_impl": ctx.moe_impl,
        "long_context_window": (model.window_override or 0),
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
    }
    comm = mesh.comm
    t0 = time.time()
    params = model.init(0, device="meta")
    specs = input_specs(cfg, shape, model, ctx)
    shardings = input_shardings(cfg, shape, model, ctx)
    mem = {"param_bytes": tree_bytes(params)}
    if shape.kind == "train":
        opt = init_adamw(params)
        batch = local_inputs(specs["batch"], shardings["batch"], ctx)
        mem["opt_bytes"] = tree_bytes((opt.m, opt.v)) + 4
        mem["input_bytes"] = tree_bytes(batch)
        step = make_train_step(model)
        args = (params, opt, specs["batch"])
    elif shape.kind == "prefill":
        mem["input_bytes"] = tree_bytes(local_inputs(
            {k: v for k, v in specs.items()},
            {k: shardings[k] for k in specs}, ctx))
        step = make_prefill_step(model)
        args = (params, specs["tokens"], specs.get("memory"))
    else:
        cache = _decode_cache(model, shape.global_batch, shape.seq_len)
        mem["cache_bytes"] = tree_bytes(cache)
        mem["input_bytes"] = tree_bytes(local_inputs(
            {k: specs[k] for k in ("tokens", "positions")},
            {k: shardings[k] for k in ("tokens", "positions")}, ctx))
        step = make_serve_step(model)
        args = (params, cache, specs["tokens"], specs["positions"])
    comm.sent.clear()
    with runtime.shapes_only():
        step(*args)
    rec["lower_s"] = time.time() - t0
    total = sum(mem.values())
    mem.update(argument_bytes=total, peak_bytes_estimate=total)
    rec["memory_analysis"] = mem
    rec["comm_sent"] = dict(comm.sent)
    coll = {k: 0 for k in COLLECTIVE_KIND.values()}
    for k, v in comm.sent.items():
        coll[COLLECTIVE_KIND[k]] += int(v)
    model_flops = analytic_model_flops(cfg, shape)
    terms = RooflineTerms(flops=model_flops / mesh.size, hbm_bytes=total,
                          coll_bytes=coll, n_devices=mesh.size,
                          model_flops=model_flops)
    rec["roofline"] = terms.as_dict()
    return rec


def run_many(archs, shapes, meshes, out_dir: str,
             skip_existing: bool = True) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
                path = os.path.join(out_dir, tag + ".json")
                if skip_existing and os.path.exists(path):
                    with open(path) as f:
                        ok = json.load(f).get("ok", False)
                    if ok:
                        print(f"[skip] {tag}", flush=True)
                        continue
                print(f"[run ] {tag}", flush=True)
                try:
                    rec = run_one(arch, shape, mp)
                    rec["ok"] = True
                except Exception as e:
                    rec = {"arch": arch, "shape": shape, "ok": False,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                if rec.get("ok"):
                    r = rec["roofline"]
                    print(f"[ ok ] {tag} meta={rec['lower_s']:.1f}s "
                          f"tc={r['t_compute_s']:.2e} tm={r['t_memory_s']:.2e} "
                          f"tx={r['t_collective_s']:.2e} "
                          f"bound={r['bottleneck']} "
                          f"useful={r['useful_flops_ratio']:.2f}",
                          flush=True)
