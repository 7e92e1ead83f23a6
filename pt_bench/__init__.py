"""The port's benchmark:
``python3 pt_bench/run.py --workload NAME --seed N --seconds S --trace 0|1``."""
