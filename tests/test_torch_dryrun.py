"""The dry run on ``meta`` tensors and its roofline at the H100's bounds
(``launch/dryrun_lib.py``, ``roofline/analysis.py``).

* ``analytic_model_flops`` equals the reference's for every arch × input
  shape, and ``RooflineTerms`` has the reference's keys and arithmetic:
  the same inputs give the reference's terms scaled by the ratio of the
  two packages' bounds (the reference module imports no JAX). The
  bounds are the H100 datasheet's.
* Per-device parameter bytes: the shape-only init on rank 0 of the
  16×16 mesh gives each leaf the shard shape of the reference's
  ``param_shardings`` on the same mesh, for every arch (the reference in
  a subprocess with 256 host devices, ``jax.eval_shape`` only); and a
  record's ``param_bytes`` is their sum.
* ``run_one`` is ``ok`` for a MoE, a dense, a recurrent and a memory
  arch at ``train_4k`` and ``decode_32k``, with the reference's record
  keys less the compiler's, and ``run_many`` writes the reference's
  files and lines.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

from torch_mesh import ROOT

from repro.configs import ALL_ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.roofline import analysis as ref
from repro_torch.configs import ALL_ARCHS, INPUT_SHAPES, get_config
from repro_torch.roofline import analysis as port

#: one arch of each kind the dry run must take (the test's time allows
#: these)
KINDS = {"moe": "deepseek-moe-16b", "dense": "internlm2-1.8b",
         "recurrent": "mamba2-130m", "memory": "seamless-m4t-medium"}
#: the reference's record keys that need a compiler or HLO
COMPILER_KEYS = {"compile_s", "cost_analysis_raw", "hlo_bytes"}
REF_RECORD_KEYS = {"arch", "shape", "sharding_profile", "mesh", "n_devices",
                   "batch_axes", "moe_impl", "long_context_window",
                   "params_total", "params_active", "lower_s", "compile_s",
                   "memory_analysis", "cost_analysis_raw", "hlo_bytes",
                   "roofline"}


def test_registries_match():
    assert list(ALL_ARCHS) == list(REF_ARCHS)
    assert list(INPUT_SHAPES) == list(REF_SHAPES)


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_analytic_model_flops_equal_reference(arch, shape):
    assert (port.analytic_model_flops(get_config(arch), INPUT_SHAPES[shape])
            == ref.analytic_model_flops(ref_config(arch), REF_SHAPES[shape]))


@pytest.mark.parametrize("flops,hbm,coll", [
    (1e15, 1e9, {"all-gather": 10**9, "all-reduce": 3 * 10**8}),
    (1e12, 1e12, {"all-to-all": 5}),
    (0.0, 2e6, {k: 0 for k in ref.COLLECTIVE_OPS})])
def test_roofline_terms_have_reference_keys_and_arithmetic(flops, hbm, coll):
    a = port.RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                           n_devices=256, model_flops=3e16).as_dict()
    b = ref.RooflineTerms(flops=flops, hbm_bytes=hbm, coll_bytes=coll,
                          n_devices=256, model_flops=3e16).as_dict()
    assert list(a) == list(b)
    scale = {"t_compute_s": port.PEAK_FLOPS / ref.PEAK_FLOPS,
             "t_memory_s": port.HBM_BW / ref.HBM_BW,
             "t_collective_s": port.NVLINK_BW / ref.ICI_BW}
    for k, v in b.items():
        if k in scale:
            assert a[k] * scale[k] == pytest.approx(v, rel=1e-12), k
        elif k != "bottleneck":
            assert a[k] == v, k
    terms = {k[2:-2]: a[k] for k in scale}
    assert a["bottleneck"] == max(terms, key=terms.get)


def test_bounds_are_the_h100_datasheet():
    assert (port.PEAK_FLOPS, port.HBM_BW, port.NVLINK_BW) == (
        989e12, 3.35e12, 450e9)
    assert port.COLLECTIVE_OPS == ref.COLLECTIVE_OPS
    assert "datasheet" in port.__doc__ and "H100 80GB HBM3" in port.__doc__


REF_SHARDS = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
sys.path.insert(0, "src")
import jax
from repro.configs import ALL_ARCHS, get_config
from repro.launch import sharding as shd
from repro.launch.mesh import make_production_mesh
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
mesh = make_production_mesh()
out = {}
for arch in ALL_ARCHS:
    m = build_model(get_config(arch), MeshCtx(mesh=mesh))
    shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))
    sh = shd.param_shardings(shapes, mesh)
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out[arch] = {
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
        [list(sd.shard_shape(s.shape)),
         s.dtype.itemsize]
        for (p, s), sd in zip(flat, jax.tree_util.tree_leaves(sh))}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_shards():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_SHARDS)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list(ALL_ARCHS))
def test_per_device_param_bytes_equal_reference_shards(ref_shards, arch):
    from repro_torch.launch.dryrun_lib import dry_mesh, tree_bytes
    from repro_torch.launch.sharding import leaves_by_path
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import build_model

    m = build_model(get_config(arch), MeshCtx(mesh=dry_mesh(False)))
    params = m.init(0, device="meta")
    got = {".".join(str(k) for k in keys): (list(t.shape), t.element_size())
           for keys, t in leaves_by_path(params).items()}
    want = {k: (s, b) for k, (s, b) in ref_shards[arch].items()}
    assert got == want
    assert tree_bytes(params) == sum(b * math.prod(s)
                                     for s, b in want.values())


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_run_one_is_ok(kind, shape):
    from repro_torch.launch.dryrun_lib import run_one

    rec = run_one(KINDS[kind], shape, False)
    assert set(rec) == (REF_RECORD_KEYS - COMPILER_KEYS) | {"comm_sent"}
    mem = rec["memory_analysis"]
    assert mem["param_bytes"] > 0 and mem["argument_bytes"] == sum(
        v for k, v in mem.items()
        if k not in ("argument_bytes", "peak_bytes_estimate"))
    r = rec["roofline"]
    cfg, sh = get_config(KINDS[kind]), INPUT_SHAPES[shape]
    assert r["model_flops"] == port.analytic_model_flops(cfg, sh)
    assert r["flops_per_device"] * 256 == pytest.approx(r["model_flops"])
    assert sum(r["collective_bytes_per_device"].values()) == sum(
        rec["comm_sent"].values()) > 0
    if shape == "train_4k":
        # the backward moved bytes of its own
        assert any(k.endswith(".bwd") for k in rec["comm_sent"])
        # AdamW's float32 m and v, and its int32 step
        assert mem["opt_bytes"] > 2 * mem["param_bytes"]
    else:
        assert mem["cache_bytes"] > 0


def test_run_many_writes_the_reference_files(tmp_path, capsys):
    from repro_torch.launch.dryrun import main

    main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
          "single", "--out", str(tmp_path)])
    path = tmp_path / "mamba2-130m_decode_32k_16x16.json"
    with open(path) as f:
        rec = json.load(f)
    assert rec["ok"] is True and rec["arch"] == "mamba2-130m"
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "[run ] mamba2-130m_decode_32k_16x16"
    assert out[1].startswith("[ ok ] mamba2-130m_decode_32k_16x16 meta=")
    main(["--arch", "mamba2-130m", "--shape", "decode_32k", "--mesh",
          "single", "--out", str(tmp_path)])
    assert capsys.readouterr().out.strip() == (
        "[skip] mamba2-130m_decode_32k_16x16")
