"""Helpers for the port's multi-rank parity tests (``tests/test_torch_*``).

The reference runs its ``shard_map`` programs on 8 host devices in ONE
subprocess per test file (``XLA_FLAGS`` must be set before ``jax`` is
imported, and the pytest process keeps its one device), on meshes with
Auto axes, and writes every output the file needs to an ``.npz``. The
port runs the same cases in ONE ``launch.mesh.spawn`` of gloo ranks per
file, each rank a fresh process on the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

#: the reference's preamble: 8 host devices, an Auto-axis mesh maker
PREAMBLE = """
import os, sys
sys.path.insert(0, "tests")
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
from jax.experimental.shard_map import shard_map
assert jax.device_count() == 8, jax.device_count()
OUT = {}


def auto_mesh(shape, names=("data", "model")):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(names))


def put(name, a):
    a = np.asarray(a)
    OUT[name] = a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def publish(tag):
    # what OUT holds so far, written for the parent to read while the
    # rest runs
    np.savez(os.path.join(DIR, tag + ".npz"), **OUT)
    os.rename(os.path.join(DIR, tag + ".npz"), os.path.join(DIR, tag))
    OUT.clear()
"""


class Reference:
    """``body`` (after :data:`PREAMBLE`) running in a subprocess; it fills
    ``OUT`` through ``put``, and may ``publish(tag)`` part of it early.
    :meth:`part` waits for a published part, :meth:`result` for the
    rest."""

    def __init__(self, tmp_path, body: str, timeout: float = 600):
        self.dir = Path(tmp_path)
        self.timeout = timeout
        self.t0 = time.monotonic()
        prog = (f"DIR = {str(self.dir)!r}\n" + PREAMBLE
                + textwrap.dedent(body)
                + "\nnp.savez(os.path.join(DIR, 'reference.npz'), **OUT)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", prog], env=env, cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def _load(self, path: Path) -> dict:
        with np.load(path) as f:
            return {k: f[k] for k in f.files}

    def part(self, tag: str) -> dict:
        path = self.dir / tag
        while not path.exists():
            if self.proc.poll() is not None:
                self.result()                   # raises with its stderr
                raise AssertionError(f"reference never published {tag}")
            if time.monotonic() - self.t0 > self.timeout:
                self.proc.kill()
                raise AssertionError(f"reference: no {tag} in time")
            time.sleep(0.2)
        return self._load(path)

    def result(self) -> dict:
        try:
            _, err = self.proc.communicate(
                timeout=max(1.0, self.timeout
                            - (time.monotonic() - self.t0)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            raise
        assert self.proc.returncode == 0, err[-4000:]
        return self._load(self.dir / "reference.npz")


def reference(tmp_path, body: str, timeout: float = 600) -> dict:
    """Run ``body`` to its end; → its arrays."""
    return Reference(tmp_path, body, timeout).result()


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))
