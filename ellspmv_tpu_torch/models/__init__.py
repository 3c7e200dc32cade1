"""Benchmark matrix generators."""
