"""CPU tests of the benchmark: ``python3 -m pytest portbench/tests``."""
