"""Run one cell of the benchmark once:

    python -m verbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line (see ``bench.py``).
"""

import time

T_CALLED = time.perf_counter()


def _process_start() -> float:
    """The process's start on the ``perf_counter`` clock (Linux: its age
    from ``/proc``), else the time this module was first run."""
    try:
        import os
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        now = time.perf_counter()
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return now - age if 0.0 <= age < 60.0 else T_CALLED
    except (OSError, ValueError, IndexError):
        return T_CALLED


if __name__ == "__main__":
    import sys

    from verbench.bench import main
    sys.exit(main(t_start=_process_start()))
