"""Restoring trained runs for inference, and the benchmarks that score them."""
