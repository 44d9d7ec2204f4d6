"""Build, load and launch the port's CUDA kernels.

The kernels are CUDA C++ files under ``csrc/`` with a plain C interface. At
first use, :func:`library` compiles each source with ``nvcc`` for ``sm_90a``
(all sources at once, one process each), links the objects into one shared
library under ``<repo>/build/repro_torch/`` and loads it with ``ctypes``. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused. Nothing is built when a module is
imported: the CPU tests import every module, and ``nvcc`` is needed only once
a CUDA tensor reaches a wrapper.

Every launch goes through :func:`launch`, which raises on a non-zero
``cudaError_t`` from the C function and counts the launch in ``LAUNCHES``.
This module plays the role that ``repro.kernels.backend`` plays for the
Pallas kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Kernel launches per wrapper since the last reset_launches(). A wrapper adds
# one exactly where its kernel was launched, never on the CPU path.
LAUNCHES = {"nsd_quant": 0, "bitmap_pack": 0, "bsp_matmul_int8": 0,
            "bitmap_unpack": 0, "levels_compact": 0, "levels_expand": 0,
            "bsp_matmul_dequant": 0, "philox_uniform": 0}

_P, _I, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
_SIGNATURES = {
    "nsd_quant_launch": (_P, _P, _U64, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "philox_uniform_launch": (_U64, _P, _I, _I, _P),
    "bitmap_pack_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bsp_matmul_int8_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "bitmap_unpack_launch": (_P, _P, _I, _P),
    "levels_compact_launch": (_P, _P, _P, _I, _P),
    "levels_expand_launch": (_P, _P, _P, _I, _P),
    "levels_compact_wire_launch": (_P, _P, _P, _P, _P, _I, _I, _P),
    "levels_expand_wire_launch": (_P, _P, _P, _P, _I, _I, _P),
    "levels_expand_pages_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    "bsp_matmul_dequant_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}
_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _compile(sources, out: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        objs = [tmp / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{log}")
        lib_tmp = tmp / out.name
        res = subprocess.run([nvcc, "-shared", "-o", str(lib_tmp),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(lib_tmp, out)  # atomic: a concurrent loader sees all or nothing
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    global _lib
    if _lib is None:
        sources = sorted(CSRC.glob("*.cu"))
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in sorted(CSRC.glob("*.cu*")):
            h.update(f.name.encode())
            h.update(f.read_bytes())
        out = BUILD_DIR / f"libreprotorch_{h.hexdigest()[:16]}.so"
        if not out.exists():
            _compile(sources, out)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_torch_error_string.argtypes = (ctypes.c_int,)
        lib.repro_torch_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    """A tensor's data pointer for a C argument; None passes NULL."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def launch(name: str, fn_name: str, *args) -> None:
    """Call ``fn_name`` on PyTorch's current stream, raise on a CUDA error,
    and count the launch under ``name``."""
    lib = library()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        msg = lib.repro_torch_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def check_cuda_operands(name: str, *tensors: torch.Tensor, align: int = 16
                        ) -> None:
    """Raise unless every operand is a contiguous tensor on one CUDA device
    with its data aligned to ``align`` bytes (the kernels' vector loads)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operand of shape {tuple(t.shape)} is "
                             f"not contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: operand not {align}-byte aligned")
