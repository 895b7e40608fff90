"""The plain PyTorch reference of the benchmark's cells: imports nothing of
the program."""
