"""Build and bind the CUDA kernels (``csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started
together, into an object file; the objects link into one shared library
with a plain C interface, loaded with ``ctypes``.  The library goes to
``build/repro_torch_kernels/<hash>/`` at the repository root, keyed by a
hash of the sources, the flags and the compiler, and is built at first
use — from the sources in the checkout and nothing else.  Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

from repro_torch._device import find_nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("crossbar_permute.cu", "plan_program.cu", "moe_route.cu",
           "fused_compress.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_IP = ctypes.POINTER(ctypes.c_int)
# Every C entry point and its signature; each returns a cudaError_t,
# except those named in RESTYPES.
SIGNATURES = {
    "xb_scratch_ints": [_I, _I, _I, _I],
    "xb_dense": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _IP],
    "xb_sparse": [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                  _P, _IP],
    "pp_smem_optin": [_I, _P],
    "pp_megakernel": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P]
                     + [_I] * 8 + [_P, _P],
    "pp_packed": [_P, _P, _P, _I, _P] + [_I] * 13 + [_P],
    "moe_route": [_P, _P, _P] + [_I] * 12 + [_P],
    "moe_route_floor": [_I, _I, _I, _P],
    "fused_vcompress": [_P, _I, _U, _U, _I, _P, _P] + [_I] * 7 + [_P],
}
RESTYPES = {"xb_scratch_ints": ctypes.c_longlong}


class KernelLaunchError(RuntimeError):
    """A CUDA kernel failed to build, load or launch."""


class KernelBuildError(KernelLaunchError):
    """nvcc is missing or failed on the kernel sources."""


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def build_root() -> Path:
    return repo_root() / "build" / "repro_torch_kernels"


def _source_hash(nvcc: str) -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: dict = {}


def build() -> Path:
    """Compile the sources (if this hash is not built yet); return the
    library path.  Records seconds and the compiler's report in
    ``BUILD_INFO``."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found on PATH, under $CUDA_HOME/bin or "
            "/usr/local/cuda/bin: the repro_torch CUDA kernels are built "
            "from kernels/csrc at first use")
    out_dir = build_root() / _source_hash(nvcc)
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        reports, failed = [], []
        for name, _, proc in procs:
            text = proc.communicate()[0].decode(errors="replace")
            reports.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {failed}:\n" + "\n".join(reports))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             *[str(obj) for _, obj, _ in procs], "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise KernelBuildError(
                "nvcc link failed:\n" + link.stdout.decode(errors="replace"))
        report = "\n".join(reports)
        (out_dir / "build.log").write_text(report)
        os.replace(tmp_lib, lib)
    BUILD_INFO.update(path=str(lib), seconds=time.perf_counter() - t0,
                      cached=False, report=report)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelLaunchError(f"cannot load {path}: {e}") from e
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = RESTYPES.get(fn, ctypes.c_int)
            _LIB = lib
        return _LIB


def stream_handle(device) -> int:
    """The current PyTorch stream of ``device`` as a C pointer value."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
