"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``gb25_tpu_torch/_build/`` (git-ignored), named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, and loaded with
``ctypes``. Nothing here runs at import time, and nothing falls back: a
missing ``nvcc`` or a failed build raises.

Every exported launcher returns ``cudaGetLastError()`` as an int;
``CudaKernel.launch`` raises when it is not 0 and otherwise adds one to the
kernel's launch count, which a run reads to prove that its main path went
through the kernel; a launch given a ``flag`` also counts under it in
``CudaKernel.flagged`` (K1's launches whose b the kernel made).
``launch_counts`` reads every kernel's count at once (``models.device_loop``
takes what a captured graph recorded from it).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import weakref
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def build_library(source: str, extra_flags=()) -> tuple[Path, str]:
    """Compile ``csrc/<source>`` unless a library for this exact source and
    flag set exists. Returns the library path and the compiler's report
    (ptxas register and spill counts; empty when the build was cached)."""
    src = CSRC_DIR / source
    flags = (*NVCC_FLAGS, *extra_flags)
    # the shared headers too: a source includes them from its own directory
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    key = hashlib.sha256(src.read_bytes() + headers + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{src.stem}-{key}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr


_KERNELS = weakref.WeakSet()  # every CudaKernel made


def launch_counts() -> dict:
    """Every kernel's launch count, by kernel."""
    return {k: k.launches for k in list(_KERNELS)}


class CudaKernel:
    """One ``.cu`` file: its library (built at first use), its launchers'
    ctypes signatures, a plain integer launch count and the launches by
    flag (``flagged``). ``extra_flags`` are
    added to ``NVCC_FLAGS`` for this file alone."""

    def __init__(self, source: str, functions: dict, extra_flags=()):
        self.source = source
        self.functions = functions  # name -> argtypes (restype is c_int)
        self.extra_flags = tuple(extra_flags)
        self.launches = 0
        self.flagged = collections.Counter()  # flag -> launches given it
        self.build_log = ""
        self._lib = None
        _KERNELS.add(self)

    def load(self):
        if self._lib is None:
            path, self.build_log = build_library(self.source, self.extra_flags)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.gb25_cuda_error_string.argtypes = [ctypes.c_int]
            lib.gb25_cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, name: str, *args):
        """Call an exported function; raise on a CUDA error."""
        lib = self.load()
        err = getattr(lib, name)(*args)
        if err != 0:
            msg = lib.gb25_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.source}:{name} failed: CUDA error {err} ({msg})")

    def launch(self, name: str, *args, flag=None):
        """Call a launcher and count the launch (also under ``flag``, unless
        None)."""
        self.call(name, *args)
        self.launches += 1
        if flag is not None:
            self.flagged[flag] += 1


def check_tensor(t, name, shape, dtype, device):
    """Validate a tensor handed to a kernel (pointer arithmetic in C trusts
    these)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def kernel_route(kernels, device_type, dtype, dtypes=(torch.float32,)) -> bool:
    """The dispatch rule of every kernel, from the operand's device and
    dtype alone: "torch" always runs the plain version; "auto" and "pallas"
    run it on the CPU and launch the CUDA kernel for a CUDA operand of a
    dtype the kernel reads (``dtypes``: float32; K6 also bfloat16 and
    float64, its instances for ``compute_dtype="bfloat16"`` and for a
    float64 state or ``"float64"`` on the "pallas" route). A CUDA operand
    of another dtype takes the plain version: a float64 or float16 state
    under "auto", as the JAX package's ``*_supported`` gates send a
    non-float32 ``ue`` to its array path, and a float64 state's K2-K5
    under "pallas", as that route's gates do there. "pallas" raises on
    any other dtype (a float16 state): it names the kernels, and K6 has no
    instance for it. (Under "float32" and "bf16s" the step hands K1
    float32 copies of such a state, as the JAX package casts them:
    ``models.hydrostatic.k1_operand_dtype``, and K6 copies in the
    compute dtype: ``k6_operand_dtype``.)"""
    if kernels == "torch":
        return False
    if kernels not in ("auto", "pallas"):
        raise ValueError(f"unknown kernels mode {kernels!r}")
    if device_type == "cpu":
        return False
    if device_type != "cuda":
        raise ValueError(f"kernels={kernels!r} has no kernel for device {device_type}")
    if dtype in dtypes:
        return True
    if kernels == "pallas" and dtype != torch.float64:
        raise NotImplementedError(f'kernels="pallas" on a {dtype} state: the kernels take '
                                  'float32 (K6 also bfloat16 and float64); kernels="auto" '
                                  'runs their plain versions')
    return False


def uses_kernel(cfg, t, dtypes=(torch.float32,)) -> bool:
    """``kernel_route`` for the operand ``t`` under ``cfg.kernels``."""
    return kernel_route(cfg.kernels, t.device.type, t.dtype, dtypes)


def launch_info(kernel, name, *args, extra=()) -> dict:
    """A tile kernel's launch shape from its ``*_info`` entry: registers
    per thread, shared memory per block (bytes), the tile's columns in x
    and y, and the blocks one SM holds at once; then one further integer
    for each name in ``extra``."""
    out = (ctypes.c_int * (5 + len(extra)))()
    kernel.call(name, *args, out)
    return {"registers": out[0], "smem_bytes": out[1], "tile": [out[2], out[3]],
            "blocks_per_sm": out[4], **{k: out[5 + i] for i, k in enumerate(extra)}}
