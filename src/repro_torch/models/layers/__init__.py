"""Model layers of the port (plain PyTorch)."""
