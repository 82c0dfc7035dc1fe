"""Datasets, non-IID partitions and the round batching pipeline, and the
linear-regression task of paper Example 1 (``data.linreg``)."""
