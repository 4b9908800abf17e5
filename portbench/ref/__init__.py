"""Plain references that decide `correct`: numpy and plain PyTorch, with
nothing of the program imported and nothing the program made taken in."""
