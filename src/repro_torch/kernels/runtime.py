"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), loaded with :mod:`ctypes`. All sources of a build
compile in parallel, one ``nvcc`` each. Libraries are named by a hash of
their source, the shared headers (``csrc/*.cuh``) and the flags, so an
unchanged build is never redone within a build directory, and a failed
build or load raises — there is no fallback to the plain version.

Every kernel wrapper (``kernels/*/kernel.py``) adds one to
``LAUNCHES[name]`` where it launches its kernel, and nowhere else, so a
run can show which kernels its path went through. A launch that also
runs another kernel's body (route-pack's EPLB Collect block) counts once
in ``LAUNCHES``, under its own name, and once in ``FUSED`` under the
body's.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: default build directory: ``build/kernels`` at the repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name → launches since the last reset
LAUNCHES: "collections.Counter[str]" = collections.Counter()
#: kernel body → launches of another kernel that ran it since the reset
FUSED: "collections.Counter[str]" = collections.Counter()
#: source name → nvcc's output of the build that produced the library
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    FUSED.clear()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def count_fused(body: str) -> None:
    FUSED[body] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _lib_path(name: str, build_dir: Path) -> Path:
    """The library of ``csrc/<name>.cu``, tagged by a hash of that
    source, of every shared header (``*.cuh``, by name and content: a
    source may include any of them) and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir / f"lib{name}-{h.hexdigest()[:12]}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Iterable[str]] = None,
          build_dir: Optional[Path] = None) -> Dict[str, Path]:
    """Compile ``csrc/<name>.cu`` for each name (default: every source),
    all ``nvcc`` processes started together. Returns name → library
    path; raises with nvcc's output if any build fails."""
    build_dir = Path(build_dir or BUILD_DIR)
    build_dir.mkdir(parents=True, exist_ok=True)
    names = list(names) if names is not None else sources()
    out = {n: _lib_path(n, build_dir) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
        else:
            tmp.replace(out[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def stream_handle(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s
    device (a Python int, passed as ``c_void_p``). Read without making a
    ``torch.cuda.Stream`` object, whose host cost is of the order of a
    launch-bound kernel's whole device time."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_status(name: str, status: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry (a
    refused launch never runs, and a later synchronize would not say)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
