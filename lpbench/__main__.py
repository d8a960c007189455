"""`python3 -m lpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`:
one run of one cell of the benchmark (`lpbench/run.py`)."""

import time

T0 = time.perf_counter()  # set-up starts here, before the heavy imports

import sys  # noqa: E402

from lpbench.run import main  # noqa: E402

sys.exit(main(t0=T0))
