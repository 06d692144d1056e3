"""A benchmark rank process with the exchange between the ranks left out:
``collectives.cross_rank_sum`` hands each rank its own tensors back, so
every rank trains on its share of the rows alone.  The tests start the
ranks of a run with this module in place of ``port_bench``."""

import time

T_START = time.time()

from dist_keras_tpu_torch.parallel import collectives  # noqa: E402

from port_bench.run import main  # noqa: E402


def _own(tensors, axis, *args, **kwargs):
    return list(tensors)


collectives.cross_rank_sum = _own

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
