"""The benchmark of ``lsd_tpu_torch``: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for; it fails, printing no result, without them.  See ``harness.py``.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout: only a checkout's first
# run builds (the CUDA kernels of the port build into lsd_tpu_torch/_build/)
CACHE = ROOT / "port_bench" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
# one process with few threads: the host's BLAS and OpenMP pools stay at
# one thread, so that they do not spin against the launching thread
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(ROOT))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
