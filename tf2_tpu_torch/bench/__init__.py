"""Benchmark inputs of the port."""
