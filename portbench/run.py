"""The port's benchmark, one run of one cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout with a CUDA card (none: it exits non-zero and
prints no result).  The last line of standard output is the result as one
JSON object; the numbers compared with the reference, each beside its
limit, are the last lines of standard error.  See portbench/README.md.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
# one host thread for PyTorch's CPU pools: the host drives the card, and
# idle pool threads spinning beside it make the step's time jitter
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path[:0] = [HERE, ROOT]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
