"""Plain PyTorch / NumPy references of what the benchmark's cells run.

Each module follows the published description of its model or of
QPGesture's matching, reads weights by their published parameter names from
a plain dict of tensors, and imports nothing of the program under test."""
