from port_bench.tests.test_bench_faults import det_cell  # noqa: F401  (a fixture)
