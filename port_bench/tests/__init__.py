"""CPU tests of the benchmark harness: python -m pytest port_bench/tests"""
