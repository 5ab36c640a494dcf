"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, :func:`library` compiles every ``csrc/*.cu`` into one shared
library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/<hash>/libnf_tpu_torch_kernels.so csrc/*.cu

where ``<hash>`` is a digest of the sources and flags, so an edited source
builds anew.  The library is loaded with ``ctypes`` and every entry point's
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
    for src in sources:
        digest.update(src.name.encode() + src.read_bytes())
    out = BUILD / digest.hexdigest()[:16] / LIB_NAME
    if not out.exists():
        _compile(sources, out)
    lib = ctypes.CDLL(str(out))
    p, i, i64, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint64
    lib.nf_pwquad_sampler.argtypes = [p, i, p, i, p, u64, u64, p, p, i64, i, p]
    lib.nf_pwquad_sampler.restype = i
    lib.nf_pwquad_sampler_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nf_pwquad_sampler_limits.restype = i
    lib.nf_cuda_error_string.argtypes = [i]
    lib.nf_cuda_error_string.restype = ctypes.c_char_p
    _check_limits(lib)
    _LIB = lib
    return lib


def _check_limits(lib):
    from nf_tpu_torch.ops import pwquad_sampler as ps

    caps = (ctypes.c_int * 3)()
    lib.nf_pwquad_sampler_limits(caps)
    if tuple(caps) != (ps.MAX_FLOW, ps.MAX_HIDDEN, ps.MAX_BINS):
        raise RuntimeError(f"kernel caps {tuple(caps)} != wrapper caps "
                           f"{(ps.MAX_FLOW, ps.MAX_HIDDEN, ps.MAX_BINS)}")


def error_string(err: int) -> str:
    return f"cudaError {err}: {library().nf_cuda_error_string(err).decode()}"
