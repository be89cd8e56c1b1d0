"""The port's benchmark: `python3 ntt_bench/run.py --workload <cell> ...` (README.md)."""
