"""Run one cell of BENCHMARK.json once on the CUDA device(s) of this
machine and print its result as the last line of standard output.

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository.
"""

import os
import sys
import time


def process_age():
    """Seconds since this process started (Linux /proc), 0 elsewhere."""
    try:
        with open('/proc/self/stat') as f:
            start = float(f.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf('SC_CLK_TCK'), 0.)
    except (OSError, ValueError, IndexError):
        return 0.


# the set-up time counts from the process's start, on the clock that
# times the window
_START = time.perf_counter() - process_age()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from port_bench.harness.runner import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(process_start=_START))
