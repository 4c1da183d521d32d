"""The plain reference that decides `correct`: PyTorch and NumPy only,
nothing of the program."""
