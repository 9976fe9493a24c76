"""The port's examples (``examples/torch_*.py``) on the CPU (``--device
cpu``) at smoke size, against the reference's examples
(``examples/quickstart.py``, ``serve_disaggregated.py``,
``eplb_demo.py``) run in the same process: the printed lines are the
same, but for the host-clock TTFT and TPOT.

The reference's examples build their engines on the Explicit-axis smoke
mesh, where its MoE and cache-write paths raise on this JAX: the test
hands them the Auto-axis mesh of ``tests/torch_parity.py``. The
quickstarts run in float32 with the reference's seed-0 weights on both
sides (the port's ``Model.init`` returns them), and the token ids behind
each printed text are compared too (a byte tokenizer prints nothing for
ids past 255); the VLM quickstart feeds both engines the port example's
seeded memory. Without a card, the examples' default device raises."""
import functools
import importlib.util
import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.core import DisaggregatedPD as JaxPD
from repro.serving import FlowServeEngine as JaxEngine
from repro.serving import request as jax_request
from repro.serving import tokenizer as jax_tokenizer
from repro_torch.models.transformer import Model, seeded_memory
from repro_torch.serving import request as torch_request
from repro_torch.serving import tokenizer as torch_tokenizer
from torch_parity import auto_ctx, configs, reference

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, monkeypatch, main, argv=None):
    """``main`` of an example; its printed lines, host clock removed.
    Request ids count from 0, as in a fresh process."""
    for mod in (jax_request, torch_request):
        monkeypatch.setattr(mod, "_req_ids", itertools.count())
    if argv is None:                   # the reference's read sys.argv
        monkeypatch.setattr("sys.argv", ["example"])
        main()
    else:
        main(argv)
    return [re.sub(r"ttft=\d+ms tpot=[\d.]+ms/token ", "", line)
            for line in capsys.readouterr().out.splitlines()]


@pytest.fixture
def decoded(monkeypatch):
    """package name → the token id lists its tokenizer decoded."""
    seen = {"jax": [], "torch": []}
    for name, mod in (("jax", jax_tokenizer), ("torch", torch_tokenizer)):
        real = mod.ByteTokenizer.decode

        def spy(self, ids, _real=real, _seen=seen[name]):
            _seen.append([int(i) for i in ids])
            return _real(self, ids)
        monkeypatch.setattr(mod.ByteTokenizer, "decode", spy)
    return seen


#: quickstart arch → parity config
QUICK = {"internlm2-1.8b": "internlm2", "llama-3.2-vision-11b": "vision"}


@pytest.mark.parametrize("arch", list(QUICK))
def test_quickstart_matches_reference(arch, capsys, monkeypatch, decoded):
    config = QUICK[arch]
    jcfg, _, jparams, tcfg, tparams = reference("float32", config=config)
    ref, port = _load("quickstart"), _load("torch_quickstart")
    mem = None
    if config == "vision":
        mem = jnp.asarray(seeded_memory(
            tcfg, torch.Generator().manual_seed(0), "cpu").numpy())
    monkeypatch.setattr(ref, "get_config", lambda name: jcfg)
    monkeypatch.setattr(ref, "FlowServeEngine", functools.partial(
        JaxEngine, params=jparams, ctx=auto_ctx(), memory=mem))
    monkeypatch.setattr(port, "get_config", lambda name: tcfg)
    monkeypatch.setattr(Model, "init",
                        lambda self, seed=0, *, device="cuda": tparams)
    want = _run(capsys, monkeypatch, ref.main)
    got = _run(capsys, monkeypatch, port.main,
               ["--arch", arch, "--device", "cpu"])
    assert got == want and len(got) == 6
    assert decoded["torch"] == decoded["jax"] and len(decoded["jax"]) == 3
    assert all(len(ids) == 16 for ids in decoded["jax"])


def test_serve_disaggregated_matches_reference(capsys, monkeypatch):
    ref = _load("serve_disaggregated")
    monkeypatch.setattr(ref, "DisaggregatedPD",
                        functools.partial(JaxPD, ctx=auto_ctx()))
    want = _run(capsys, monkeypatch, ref.main)
    got = _run(capsys, monkeypatch, _load("torch_serve_disaggregated").main,
               ["--device", "cpu"])
    assert got == want and len(got) == 7
    assert all("tokens=10" in line for line in got if line.startswith("[req"))


def test_eplb_demo_matches_reference(capsys, monkeypatch):
    want = _run(capsys, monkeypatch, _load("eplb_demo").main)
    got = _run(capsys, monkeypatch, _load("torch_eplb_demo").main,
               ["--device", "cpu"])
    assert got == want and len(got) == 6


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_serve_disaggregated",
                                  "torch_eplb_demo"])
def test_examples_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])
