"""Build and load the port's CUDA kernels (nvcc + ctypes, no torch headers).

Each ``csrc/<name>.cu`` exports a plain C function and is compiled by
``nvcc`` for ``sm_90a`` into ``build/repro_torch/lib<name>-<hash>.so`` at
first use; the hash covers the source and the flags, so an edit rebuilds.
``build()`` starts one nvcc per missing library, all at once, and waits
for them. A failed build or a missing nvcc raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("paged_decode_attention", "flash_attention", "packed_canvas",
           "grouped_mvm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}")
    return path


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` not built yet, in parallel.
    Returns nvcc's output (ptxas register and shared-memory report) per
    library it compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, errors = {}, []
    for name, out, tmp, proc in jobs:
        logs[name], _ = proc.communicate()
        if proc.returncode:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return logs


def function(lib: str, fn: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``fn`` of library ``lib`` (built on first use), with
    its argument types declared; every entry returns a cudaError_t."""
    key = (lib, fn)
    if key not in _fns:
        if lib not in _libs:
            build([lib])
            _libs[lib] = ctypes.CDLL(str(library_path(lib)))
        f = getattr(_libs[lib], fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``: the kernels' split plans size
    their grids by it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would need a gradient through a kernel that
    has no backward: its output is written by the kernel and has no
    graph, so the gradient would be dropped without a word."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: an input requires grad, but this kernel has no "
            f"backward; call it under torch.no_grad(), or on CPU tensors "
            f"for the differentiable plain version")


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")
