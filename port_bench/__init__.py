"""The benchmark of the PyTorch and CUDA port (``dist_keras_tpu_torch``).

``python3 -m port_bench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints its result
as the last line of standard output (``port_bench/run.py``).
"""
