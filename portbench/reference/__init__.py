"""Plain references of the timed paths, in PyTorch; they import nothing of
the program."""
