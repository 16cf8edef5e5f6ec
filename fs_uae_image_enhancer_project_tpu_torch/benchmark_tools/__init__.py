"""The design benchmarks of the root ``benchmark_tools/``, on the port."""
