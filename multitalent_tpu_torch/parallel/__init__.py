"""Data parallelism over ranks (parallel/distributed.py)."""
