import time

T_START = time.time()   # the run's start: set-up is counted from here

from port_bench.run import main  # noqa: E402

raise SystemExit(main(t_start=T_START))
