"""The plain PyTorch reference the program is held to."""
