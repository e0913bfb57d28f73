"""Datasources (reference: ``pkg/gofr/datasource``).

Each datasource follows the reference's integration idiom (SURVEY §1):
config-gated creation in the container, a ``health_check()`` method, metrics
hooks, and small local logger/metrics seams instead of importing the world
(reference ``datasource/logger.go:3-8`` — "accept interfaces, return
concrete types").

The port's copy of ``gofr_tpu/datasource/__init__.py``.
"""
