"""The benchmark of abacusutils_tpu_torch: HOD likelihood evaluations on an
NVIDIA GPU. ``python benchmark/run.py --workload <cell> --seed <n> --seconds
<s> --trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
