"""Offline dataset generators."""
