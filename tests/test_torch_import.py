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
