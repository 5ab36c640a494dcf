"""Build the port's CUDA kernels with nvcc and load them with ctypes.

At first use, :func:`library` compiles every ``csrc/*.cu`` (the sampler and
the training kernels, which include ``csrc/flow_plan.cuh``, the optimizer
update, the op-chain kernel of the per-op cost calibration and the bin-axis
scan) with one
nvcc process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c csrc/<name>.cu -o build/<hash>/<name>.o

and links the objects into one shared library with a plain C interface,
``build/<hash>/libnf_tpu_torch_kernels.so``, where ``<hash>`` is a digest
of the sources, the header and the flags, so an edited source builds anew.
The library is loaded with ``ctypes`` and every entry point's ``argtypes``
/ ``restype`` are declared here.  A missing nvcc or a failed build raises
with nvcc's output.  Nothing is downloaded.
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
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

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


def _run(cmds):
    """Run nvcc commands side by side; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = None
    for cmd, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{output}"
    if failed:
        raise RuntimeError(failed)


def _compile(sources, out: Path):
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objects = [work / (Path(src).stem + ".o") for src in sources]
        _run([[nvcc_path(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
              for src, obj in zip(sources, objects)])
        tmp = work / LIB_NAME
        _run([[nvcc_path(), *GENCODE, "-shared", "-o", str(tmp), *map(str, objects)]])
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
    lib.nf_pwquad_sampler.argtypes = [p, i, p, i, p, i, p, u64, u64, p, p, i64, i, i, i, i, i,
                                      i, i64, i, p]
    lib.nf_pwquad_sampler.restype = i
    lib.nf_pwquad_sampler_tiled.argtypes = [p, i, p, i, p, p, u64, u64, p, p, i64, i, i, i, i,
                                            i, i, i, i, i64, i, p]
    lib.nf_pwquad_sampler_tiled.restype = i
    lib.nf_pwquad_sampler_tiled_occupancy.argtypes = [i, i, i64, ctypes.POINTER(ctypes.c_int)]
    lib.nf_pwquad_sampler_tiled_occupancy.restype = i
    lib.nf_pwquad_train_fwd.argtypes = [p, i, p, i, p, i, p, p, p, p, p, i, i, i64, i, i, i,
                                        i, i, i, i64, p]
    lib.nf_pwquad_train_fwd.restype = i
    lib.nf_pwquad_train_bwd.argtypes = [p, i, p, i, p, p, p, p, p, p, i64, i, i, i, i, i,
                                        i, i64, p, i64, i, ctypes.POINTER(ctypes.c_int), p]
    lib.nf_pwquad_train_bwd_tiled.argtypes = [p, i, p, i, p, i, p, p, p, p, p, p, i64, i, i,
                                              i, i, i, ctypes.POINTER(ctypes.c_int), i64, p]
    lib.nf_pwquad_train_bwd_tiled.restype = i
    lib.nf_pwquad_train_bwd_tiled_occupancy.argtypes = [i, i, i, i64,
                                                        ctypes.POINTER(ctypes.c_int)]
    lib.nf_pwquad_train_bwd_tiled_occupancy.restype = i
    lib.nf_pwquad_train_bwd.restype = i
    d = ctypes.c_double
    lib.nf_optim_step.argtypes = [i, i, i, p, p, p, p, p, p, p, p, i64, d, d, d, d, d, i, p]
    lib.nf_optim_step.restype = i
    lib.nf_op_chain.argtypes = [i, i, i, i, i, p, p, p]
    lib.nf_op_chain.restype = i
    lib.nf_bin_scan.argtypes = [p, p, i64, i, i, i, p]
    lib.nf_bin_scan.restype = i
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

    sampler = (ps.SAMPLER_MAX_BLOCK, ps.SAMPLER_TILED_BLOCK, ps.SAMPLER_TILED_MIN_BLOCKS)
    train = (pt.BWD_LOCAL_FLOW, pt.BWD_LOCAL_HIDDEN, pt.BWD_LOCAL_BINS, pt.BWD_LOCAL_ACTS,
             pt.FWD_MAX_BLOCK, pt.BWD_MAX_BLOCK, pt.BWD_TILED_MAX_FIN, pt.BWD_TILED_MAX_BLOCK,
             *(pt.BWD_TILED_MIN_BLOCKS[rt] for rt in (1, 2, 4)))
    for fn, want in ((lib.nf_pwquad_sampler_limits, sampler),
                     (lib.nf_pwquad_train_limits, train)):
        caps = (ctypes.c_int * len(want))()
        fn(caps)
        if tuple(caps) != want:
            raise RuntimeError(f"{fn.__name__}: kernel sizes {tuple(caps)} != "
                               f"wrapper sizes {want}")


def error_string(err: int) -> str:
    return f"cudaError {err}: {library().nf_cuda_error_string(err).decode()}"
