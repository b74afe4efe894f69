"""Restoring trained runs for inference."""
