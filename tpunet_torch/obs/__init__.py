"""Observability: the metrics registry (``registry``) the serving path uses."""
