"""The plain reference that decides a run's ``correct``: PyTorch and
NumPy only, nothing of the program."""
