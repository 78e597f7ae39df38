"""``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>``"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402

from portbench.harness import main  # noqa: E402

sys.exit(main(t0=T0))
