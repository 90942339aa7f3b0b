"""Shared helpers for the hand-written CUDA kernels of the port.

Counterpart of ``repro/kernels/common.py``: the integer helpers are the
same; the ``INTERPRET`` switch has no counterpart.  A kernel wrapper
takes its plain PyTorch version only for a tensor that lies on the CPU
and launches its kernel (or raises) for a CUDA tensor.  The kernels take
float32/float64 values; :func:`split_complex` runs complex values on the
card through them, one real part at a time.

The kernels live in ``src/repro_torch/csrc/*.cu``.  Each source is
compiled by ``nvcc`` into its own shared library with a plain C
interface and bound with :mod:`ctypes`; the build happens at first use,
into ``build/repro_torch/`` at the root of the checkout, under a name
that carries a hash of the source, the ``csrc`` files it includes and
the flags (a changed source rebuilds, an unchanged one loads).  A failed
build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import operator
import os
import re
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


def _parts(x: torch.Tensor):
    """``(real, imag)`` of ``x``; ``imag`` is ``None`` for a real ``x``."""
    if x.is_complex():
        return x.real, x.imag
    return x, None


def _each(op, *outs):
    """``op`` over results that are tensors or tuples of tensors."""
    if isinstance(outs[0], tuple):
        return tuple(op(*z) for z in zip(*outs))
    return op(*outs)


def on_card_complex(dtype: torch.dtype, device: torch.device) -> bool:
    """Complex values on the card: the kernels take their real parts
    (:func:`split_complex`); the CPU's plain versions take complex values
    as they are."""
    return dtype.is_complex and device.type != "cpu"


def split_complex(fn, a: torch.Tensor, b: torch.Tensor | None = None):
    """``fn`` of complex operands, computed by its real kernels.

    ``fn(a)`` must be real-linear in ``a``, or ``fn(a, b)`` real-linear
    in each operand (a sum of products): the complex operands are split
    into their real and imaginary parts, the parts go through ``fn``,
    and the results are put together again::

        fn(ar + i ai)              = fn(ar) + i fn(ai)
        fn(ar + i ai, br + i bi)   = fn(ar, br) - fn(ai, bi)
                                     + i (fn(ar, bi) + fn(ai, br))

    A real operand is not split (two calls where one operand is
    complex).  ``fn`` may return a tensor or a tuple of tensors; each
    part of the result has the error of ``fn`` on that part's terms.
    """
    parts = [*_parts(a), *(_parts(b) if b is not None else (None, None))]
    # one real type for every part the kernels see: 16-bit widens
    real = functools.reduce(torch.promote_types,
                            [p.dtype for p in parts if p is not None])
    if real in (torch.float16, torch.bfloat16):
        real = torch.float32
    ar, ai, br, bi = (None if p is None else p.to(real).contiguous()
                      for p in parts)
    if b is None:
        return fn(ar) if ai is None else _each(torch.complex, fn(ar),
                                                fn(ai))
    if ai is None and bi is None:
        return fn(ar, br)
    if ai is None:
        return _each(torch.complex, fn(ar, br), fn(ar, bi))
    if bi is None:
        return _each(torch.complex, fn(ar, br), fn(ai, br))
    return _each(torch.complex,
                 _each(operator.sub, fn(ar, br), fn(ai, bi)),
                 _each(operator.add, fn(ar, bi), fn(ai, br)))


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


def _with_includes(path: Path, seen: set) -> bytes:
    """The bytes of a source and of every ``csrc`` file it includes,
    at any depth, each once."""
    seen.add(path.name)
    src = path.read_bytes()
    for inc in re.findall(rb'^#include "([^"]+)"', src, re.M):
        if inc.decode() not in seen:
            src += _with_includes(CSRC_DIR / inc.decode(), seen)
    return src


def _lib_path(name: str) -> Path:
    # a source that includes another of csrc/ rebuilds when that one does
    src = _with_includes(CSRC_DIR / f"{name}.cu", set())
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
