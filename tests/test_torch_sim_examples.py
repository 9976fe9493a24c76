"""The port's simulator examples print the reference examples' lines.

Both examples' ``main()`` run in this process, and every printed figure
is compared as text.

Deviation from the examples' configuration: both packages' runs patch
``WorkloadConfig(mean_output=32, max_output=64)`` over the examples'
defaults (a 512-token cap). The drain of the longest request sets a
run's event count, and at the 512-token cap the two pairs take over two
minutes. Every other field (the deployment, the arrival rate, the
faults, the seeds) is the examples' own; the 512-token cap itself is
compared only by running the two example scripts and diffing their
output.
"""
import importlib.util
from pathlib import Path

import pytest

import repro.sim as jax_sim
import repro_torch.sim as torch_sim

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(name, sim, capsys, monkeypatch):
    mod = _load(name)
    assert mod.WorkloadConfig is sim.WorkloadConfig

    def short_outputs(**kw):
        return sim.WorkloadConfig(**{**kw, "mean_output": 32,
                                     "max_output": 64})
    monkeypatch.setattr(mod, "WorkloadConfig", short_outputs)
    mod.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("name", ["sim_superpod", "sim_moe_attn"])
def test_example_prints_the_reference_lines(name, capsys, monkeypatch):
    want = _lines(name, jax_sim, capsys, monkeypatch)
    got = _lines(f"torch_{name}", torch_sim, capsys, monkeypatch)
    assert got == want
    assert len(got) >= 6 and got[0].startswith("partition plan: 480")
    # every serving run finished all its requests
    runs = [line for line in got if "finished=" in line]
    assert len(runs) == (5 if name == "sim_superpod" else 7)
    for line in runs:
        done, total = line.split("finished=")[1].split()[0].split("/")
        assert done == total
