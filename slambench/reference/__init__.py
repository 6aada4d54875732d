"""The plain reference of the benchmark: plain PyTorch and numpy, frozen
copies of the port's plain versions where they are the same arithmetic.
It imports nothing of the program."""
