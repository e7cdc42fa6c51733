"""One run of one benchmark cell of ``dsp_tpu_torch`` on this machine's card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the result as one JSON line, the
last of standard output, and the numbers compared with the reference,
each with its limit, as the last lines of standard error.  With
``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a ``torch.profiler`` trace
of a shorter window.  Exits with a code other than 0, and prints no result, where no CUDA card is present,
where the program is missing from the checkout, and where a module of
JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# kernel caches at fixed paths inside the checkout, so that only a
# checkout's first run compiles
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    from benchmark import harness

    harness.main(parse(), T_PROCESS)
