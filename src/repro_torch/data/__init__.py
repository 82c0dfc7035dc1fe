"""Datasets, non-IID partitions and the round batching pipeline."""
