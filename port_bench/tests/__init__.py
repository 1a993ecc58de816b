"""CPU tests of the benchmark (``python -m pytest port_bench/tests``)."""
