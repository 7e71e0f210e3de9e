"""Training utilities: the metrics sink."""
