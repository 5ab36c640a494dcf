"""Run one benchmark cell once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for.  The last line of standard output is the result's JSON; the last
lines of standard error are the check's numbers beside their limits.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one process with few threads: the host's share of each call stays steady
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
# every cache the run writes stays inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "benchmark", ".cache", "torch_extensions")
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0, ROOT))
