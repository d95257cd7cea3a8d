"""Plain PyTorch references of the benchmark's cells (no kernel, no import of
the program)."""
