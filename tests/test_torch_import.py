"""The port's import boundary and device defaults.

``repro_torch`` imports neither JAX nor the JAX package (not even its
JAX-free modules), and its entry points run on the card unless the
caller asks for the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(",".join(sorted(names)), bad)
"""


def test_import_loads_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(None, 1)
    # every module of the package, as its files say, was imported
    on_disk = {".".join(p.relative_to(SRC).with_suffix("").parts)
               .removesuffix(".__init__")
               for p in PORT.rglob("*.py")} - {"repro_torch"}
    assert set(out[0].split(",")) == on_disk, out[0]
    assert out[1].strip() == "[]", out[1]
    # the INT8 path: its kernels' three files each, and the quant package
    assert {f"repro_torch.kernels.{k}.{f}"
            for k in ("quant_dispatch", "int8_matmul", "collect")
            for f in ("kernel", "ops", "ref")} <= on_disk
    assert {f"repro_torch.quant.{m}" for m in
            ("int8", "smoothquant", "gptq", "kvcache_quant")} <= on_disk
    # disaggregated PD: the core and xccl subpackages, and DistFlow
    assert {"repro_torch.core", "repro_torch.core.pd_disagg",
            "repro_torch.xccl", "repro_torch.xccl.topology",
            "repro_torch.xccl.pd_transfer",
            "repro_torch.serving.distflow"} <= on_disk
    # Transformerless units, MoE-Attention disaggregation, the A2E wire
    # format and the serving launcher
    assert {"repro_torch.core.transformerless", "repro_torch.core.dataflow",
            "repro_torch.core.moe_attn_disagg", "repro_torch.xccl.routing",
            "repro_torch.launch", "repro_torch.launch.serve"} <= on_disk
    # the recurrent mixers: RG-LRU (RecurrentGemma) and Mamba-2's SSD
    assert {"repro_torch.models.rglru", "repro_torch.models.ssm"} <= on_disk
    # the dry run and its roofline
    assert {"repro_torch.roofline", "repro_torch.roofline.analysis",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.dryrun_lib"} <= on_disk
    # the SuperPod simulator
    assert {"repro_torch.sim", "repro_torch.sim.engine",
            "repro_torch.sim.events", "repro_torch.sim.fabric",
            "repro_torch.sim.metrics", "repro_torch.sim.workload"} <= on_disk
    # training: the train package, its launcher and the step functions
    assert {"repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.data", "repro_torch.train.checkpoint",
            "repro_torch.train.train_loop", "repro_torch.launch.train",
            "repro_torch.launch.steps"} <= on_disk
    # the multi-device layer: the mesh context, meshes and sharding
    # rules, and the §3.1 ring-buffer protocol
    assert {"repro_torch.models.mesh_ctx", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding",
            "repro_torch.xccl.primitives"} <= on_disk
    # serving on a mesh: MTP, prefix KV and the pod directory, and PD
    # with the KV moved between rank groups
    assert {"repro_torch.serving.mtp", "repro_torch.serving.backend",
            "repro_torch.serving.dp_group", "repro_torch.serving.kv_cache",
            "repro_torch.serving.flowserve", "repro_torch.serving.distflow",
            "repro_torch.xccl.pd_transfer",
            "repro_torch.core.pd_disagg"} <= on_disk


@pytest.mark.parametrize("needle", ["import jax", "from jax", "import repro.",
                                    "from repro.", "import repro\n",
                                    "from repro import"])
def test_source_never_names_the_reference(needle):
    """Neither the package nor ``chip_smoke.py``, which drives it on the
    card."""
    files = [*PORT.rglob("*.py"), SRC.parent / "chip_smoke.py"]
    hits = [p.name for p in files if needle in p.read_text()]
    assert not hits, f"{needle!r} in {hits}"


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")


def test_engine_defaults_to_the_card():
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.serving.flowserve import FlowServeEngine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowServeEngine(get_config("deepseek-v3-671b-smoke"))
    from repro_torch.core import DisaggregatedPD
    from repro_torch.models.mesh_ctx import make_smoke_ctx
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedPD(get_config("deepseek-v3-671b-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggregatedPD(get_config("deepseek-v3-671b-smoke"),
                        ctx=make_smoke_ctx())
    # a decode rank keeps the KV it receives on the card by default
    from repro_torch.xccl.pd_transfer import KVLayout
    assert KVLayout(make_smoke_ctx()).device == "cuda"


def test_backend_and_model_init_default_to_the_card():
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import Model
    from repro_torch.serving.backend import TorchBackend
    model = Model(get_config("deepseek-v3-671b-smoke"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0)
    params = model.init(0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_cache(1, 8)


def test_training_entry_points_default_to_the_card(tmp_path):
    _no_card()
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.train import (TrainConfig, Trainer, restore_checkpoint,
                                   save_checkpoint)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_config("internlm2-1.8b-smoke"), TrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        restore_checkpoint(str(tmp_path))


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper takes its plain version only for a CPU tensor."""
    from repro_torch.kernels.gmm.ops import expert_ffn
    from repro_torch.kernels.route_pack.ops import fused_route_pack
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_route_pack(x, torch.zeros((2,), dtype=torch.int32,
                                        device="meta"), n_dest=2, capacity=4)
    b = torch.zeros((2, 4, 4), device="meta")
    w = torch.zeros((2, 4, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        expert_ffn(b, w, w, w)


def test_quant_entry_points_follow_their_inputs():
    """The INT8 package has no device argument: it runs where its tensors
    lie, so a tensor on another device than the card or the CPU raises."""
    from repro_torch.quant import (quantize_act_tokenwise, quantize_mla_cache,
                                   quantized_linear, QTensor)
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        quantize_act_tokenwise(x)
    with pytest.raises(ValueError, match="no kernel"):
        quantize_mla_cache({"ckv": x, "krope": x})
    w = QTensor(torch.zeros((4, 3), dtype=torch.int8, device="meta"),
                torch.zeros(3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        quantized_linear(x, w)
