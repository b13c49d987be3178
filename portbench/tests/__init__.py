"""CPU and card tests of the benchmark (not of the program)."""
