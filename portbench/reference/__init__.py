"""The benchmark's plain references: float32 PyTorch, importing nothing of
the program under test."""
