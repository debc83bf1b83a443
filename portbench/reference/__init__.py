"""Plain PyTorch reference of the benchmarked models; imports nothing of
the program under test."""
