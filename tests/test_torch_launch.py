"""The port's serving launcher (``python -m repro_torch.launch.serve``)
on the CPU (``--device cpu``), in both modes on the smoke InternLM2 in
float32, against the reference's engines built on the Auto-axis mesh
with the same weights (the reference's own launcher builds them on the
Explicit-axis smoke mesh): the launcher prints, line for line, what the
reference ``FlowServeEngine`` and ``DisaggregatedPD`` give for the same
prompts, and the token ids behind each printed text are the reference's
(a byte tokenizer prints nothing for ids past the bytes, so the text
alone would hide a difference). The same for the recurrent and hybrid
families, ``--arch recurrentgemma-2b`` (the smoke config with its
2-layer tail) and ``--arch mamba2-130m``, whose prefills take the
buffering default and whose PD transfers the bulk path. Without a card,
the launcher's default device raises."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import DisaggregatedPD as JaxPD
from repro.serving import FlowServeEngine as JaxEngine
from repro.serving import tokenizer as jax_tokenizer
from repro.serving.request import Request as JaxRequest
from repro_torch.configs import get_config as torch_get_config
from repro_torch.launch import serve
from repro_torch.models.transformer import Model
from repro_torch.serving import tokenizer as torch_tokenizer
from torch_parity import auto_ctx, configs, reference

ARCH = "internlm2-1.8b"
PROMPTS = ["hello from xdeepserve", "the pod serves"]
N_NEW = 6


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


@pytest.fixture
def launcher(monkeypatch, capsys):
    """Runs ``serve.main`` on the CPU with the smoke config in float32
    and the reference's seed-0 weights; returns its printed lines."""
    _, _, _, tcfg, tparams = reference("float32", config="internlm2")

    def f32_config(name):
        assert name == ARCH + "-smoke", name
        return dataclasses.replace(torch_get_config(name), dtype="float32")
    monkeypatch.setattr(serve, "get_config", f32_config)
    monkeypatch.setattr(Model, "init",
                        lambda self, seed=0, *, device="cuda": tparams)

    def run(*argv):
        serve.main(["--arch", ARCH, "--device", "cpu", "--max-new-tokens",
                    str(N_NEW), *(a for p in PROMPTS
                                  for a in ("--prompt", p)), *argv])
        return capsys.readouterr().out.splitlines()
    return run


def test_launch_colocated_matches_reference(launcher, decoded):
    jcfg, _, jparams, _, _ = reference("float32", config="internlm2")
    eng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                    max_batch=2, max_len=256)
    outs = eng.generate(PROMPTS, N_NEW)
    eng.close()
    want = [f"{p!r} -> {o!r}" for p, o in zip(PROMPTS, outs)]
    assert launcher() == want
    assert decoded["torch"] == decoded["jax"]
    assert len(decoded["jax"]) == len(PROMPTS)
    assert all(len(ids) == N_NEW for ids in decoded["jax"])


def test_launch_pd_disagg_matches_reference(launcher, decoded):
    jcfg, _, jparams, _, _ = reference("float32", config="internlm2")
    pd = JaxPD(jcfg, jparams, ctx=auto_ctx(), n_prefill_te=2,
               n_decode_te=1, dp_per_te=2, max_batch=2, max_len=256)
    reqs = [JaxRequest(prompt=p, max_new_tokens=N_NEW, ignore_eos=True)
            for p in PROMPTS]
    done = pd.run_until_done(reqs)
    want = [f"{r.prompt!r} (p{r.prefill_te}->d{r.decode_te}) -> "
            f"{pd.tokenizer.decode(r.output_tokens)!r}"
            for r in sorted(done, key=lambda r: r.req_id)]
    pd.close()
    assert launcher("--mode", "pd-disagg") == want
    assert decoded["torch"] == decoded["jax"]
    assert len(decoded["jax"]) == len(PROMPTS)
    assert all(len(ids) == N_NEW for ids in decoded["jax"])


def test_launch_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--max-new-tokens", "1"])


def test_launch_module_exits_cleanly_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu`` serves its
    prompt and exits with 0 (``DPGroup.close`` joins the output worker;
    a daemon thread still emitting at interpreter exit aborted it)."""
    src = Path(__file__).resolve().parents[1] / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--max-new-tokens", "2"],
        env=dict(os.environ, PYTHONPATH=str(src)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1 and lines[0].startswith(
        "'hello from xdeepserve' -> "), lines


#: the recurrent and hybrid families: launcher arch → parity config
HYBRID = {"recurrentgemma-2b": "recurrentgemma", "mamba2-130m": "mamba2"}


@pytest.fixture
def hybrid_launcher(monkeypatch, capsys):
    """``launcher`` for an arch of :data:`HYBRID`: its parity config in
    float32 and the reference's seed-0 weights."""
    def make(arch):
        config = HYBRID[arch]
        _, _, _, _, tparams = reference("float32", config=config)
        monkeypatch.setattr(serve, "get_config", lambda name: (
            name == arch + "-smoke" and configs("float32", config=config)[1]))
        monkeypatch.setattr(Model, "init",
                            lambda self, seed=0, *, device="cuda": tparams)

        def run(*argv):
            serve.main(["--arch", arch, "--device", "cpu",
                        "--max-new-tokens", str(N_NEW),
                        *(a for p in PROMPTS for a in ("--prompt", p)),
                        *argv])
            return capsys.readouterr().out.splitlines()
        return run
    return make


@pytest.mark.parametrize("arch", list(HYBRID))
def test_launch_hybrid_colocated_matches_reference(arch, hybrid_launcher,
                                                   decoded):
    jcfg, _, jparams, _, _ = reference("float32", config=HYBRID[arch])
    eng = JaxEngine(jcfg, jparams, ctx=auto_ctx(), n_dp_groups=2,
                    max_batch=2, max_len=256)
    outs = eng.generate(PROMPTS, N_NEW)
    eng.close()
    assert hybrid_launcher(arch)() == [f"{p!r} -> {o!r}"
                                       for p, o in zip(PROMPTS, outs)]
    assert decoded["torch"] == decoded["jax"]
    assert [len(ids) for ids in decoded["jax"]] == [N_NEW] * len(PROMPTS)


@pytest.mark.parametrize("arch", list(HYBRID))
def test_launch_hybrid_pd_disagg_matches_reference(arch, hybrid_launcher,
                                                   decoded):
    jcfg, _, jparams, _, _ = reference("float32", config=HYBRID[arch])
    pd = JaxPD(jcfg, jparams, ctx=auto_ctx(), n_prefill_te=2,
               n_decode_te=1, dp_per_te=2, max_batch=2, max_len=256)
    reqs = [JaxRequest(prompt=p, max_new_tokens=N_NEW, ignore_eos=True)
            for p in PROMPTS]
    done = pd.run_until_done(reqs)
    want = [f"{r.prompt!r} (p{r.prefill_te}->d{r.decode_te}) -> "
            f"{pd.tokenizer.decode(r.output_tokens)!r}"
            for r in sorted(done, key=lambda r: r.req_id)]
    pd.close()
    assert hybrid_launcher(arch)("--mode", "pd-disagg") == want
    assert decoded["torch"] == decoded["jax"]
    assert [len(ids) for ids in decoded["jax"]] == [N_NEW] * len(PROMPTS)
