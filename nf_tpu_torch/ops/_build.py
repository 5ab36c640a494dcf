"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, :func:`library` compiles every ``csrc/*.cu`` (which include
``csrc/flow_plan.cuh``) into one shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<hash>/libnf_tpu_torch_kernels.so csrc/*.cu

where ``<hash>`` is a digest of the sources, the header and the flags, so an
edited source builds anew.  The library is loaded with ``ctypes`` and every entry point's
``argtypes`` / ``restype`` are declared here.  A missing nvcc or a failed
build raises with nvcc's output.  Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
LIB_NAME = "libnf_tpu_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB = None


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").exists():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile(sources, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    out = BUILD / digest.hexdigest()[:16] / LIB_NAME
    if not out.exists():
        _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
    lib.nf_pwquad_sampler.argtypes = [p, i, p, i, p, u64, u64, p, p, i64, i, p]
    lib.nf_pwquad_sampler.restype = i
    lib.nf_pwquad_train_fwd.argtypes = [p, i, p, i, p, p, p, p, p, i, i64, i, p]
    lib.nf_pwquad_train_fwd.restype = i
    lib.nf_pwquad_train_bwd.argtypes = [p, i, p, i, p, p, p, p, p, p, i64, i, p]
    lib.nf_pwquad_train_bwd.restype = i
    for limits in (lib.nf_pwquad_sampler_limits, lib.nf_pwquad_train_limits):
        limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        limits.restype = i
    lib.nf_cuda_error_string.argtypes = [i]
    lib.nf_cuda_error_string.restype = ctypes.c_char_p
    _check_limits(lib)
    _LIB = lib
    return lib


def _check_limits(lib):
    from nf_tpu_torch.ops import pwquad_sampler as ps
    from nf_tpu_torch.ops import pwquad_train as pt

    sampler = (ps.MAX_FLOW, ps.MAX_HIDDEN, ps.MAX_BINS)
    train = sampler + (pt.MAX_ACTS, pt.MAX_OPS, pt.TRAIN_BLOCK, pt.TRAIN_MAX_BLOCKS)
    for fn, want in ((lib.nf_pwquad_sampler_limits, sampler),
                     (lib.nf_pwquad_train_limits, train)):
        caps = (ctypes.c_int * len(want))()
        fn(caps)
        if tuple(caps) != want:
            raise RuntimeError(f"{fn.__name__}: kernel caps {tuple(caps)} != "
                               f"wrapper caps {want}")


def error_string(err: int) -> str:
    return f"cudaError {err}: {library().nf_cuda_error_string(err).decode()}"
