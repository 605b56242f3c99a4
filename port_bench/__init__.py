"""The benchmark of ``lsd_tpu_torch`` on one NVIDIA card: ``python3 port_bench/run.py``."""
