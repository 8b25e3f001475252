"""Run one benchmark cell once and print its result as the last line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Measures the PyTorch and CUDA port, ``tecogan_tpu_torch``, on the card(s)
the cell asks for; exits non-zero with no result where there is none.
"""

import time

_T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness.runner import main, process_age_s  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=_T0 - process_age_s()))
