"""Shared helpers for the hand-written CUDA kernels of the port.

Counterpart of ``repro/kernels/common.py``: the integer helpers are the
same; the ``INTERPRET`` switch has no counterpart.  A kernel wrapper
takes its plain PyTorch version only for a tensor that lies on the CPU
and launches its kernel (or raises) for a CUDA tensor.

The kernels live in ``src/repro_torch/csrc/*.cu``.  Each source is
compiled by ``nvcc`` into its own shared library with a plain C
interface and bound with :mod:`ctypes`; the build happens at first use,
into ``build/repro_torch/`` at the root of the checkout, under a name
that carries a hash of the source and the flags (a changed source
rebuilds, an unchanged one loads).  A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"

#: Hopper only: ``sm_90a`` keeps wgmma/setmaxnreg available to later PRs.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x: torch.Tensor, size: int, fill) -> torch.Tensor:
    """Pad the last axis of ``x`` up to ``size`` with ``fill``."""
    L = x.shape[-1]
    if L == size:
        return x
    pad = x.new_full(x.shape[:-1] + (size - L,), fill)
    return torch.cat([x, pad], dim=-1)


def resolve_device(device=None) -> torch.device:
    """Device for host data entering the port: ``"cuda"`` unless asked.

    There is no quiet fallback: with no card and no ``device="cpu"``,
    the call raises.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {path} and on PATH); the CUDA "
            "kernels cannot be built"
        )
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start_build(name: str):
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names) -> dict[str, str]:
    """Compile the given ``csrc/<name>.cu`` sources, all at once.

    One ``nvcc`` per source, started together and all waited for;
    returns each source's ``-Xptxas -v`` report (registers, shared
    memory, spills; empty for a library already built) and raises if
    any build failed.
    """
    logs, failed = {}, []
    with _LOCK:
        jobs = {n: _start_build(n) for n in names}
        for n, job in jobs.items():
            logs[n] = ""
            if job is None:
                continue
            proc, tmp, out = job
            logs[n], _ = proc.communicate()
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"csrc/{n}.cu (exit {proc.returncode}):\n"
                              f"{logs[n]}")
    if failed:
        raise RuntimeError("nvcc failed to build " + "\n".join(failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _LIBS[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, argtypes) -> ctypes._CFuncPtr:
    """Declare a launcher's C signature: returns a ``cudaError_t`` int."""
    f = getattr(lib, fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda_tensor(t: torch.Tensor, name: str, dtypes) -> None:
    """What every launcher needs of a tensor argument."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must have dtype in {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
