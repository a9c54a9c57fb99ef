"""The benchmark of george_tpu_torch: one cell of ``BENCHMARK.json`` per run
(``python3 gpbench/run.py --workload <name> ...``); see ``README.md``."""
