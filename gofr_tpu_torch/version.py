"""Framework version constant (reference: ``pkg/gofr/version/version.go:3``).

The port's copy of ``gofr_tpu/version.py``.
"""

FRAMEWORK_VERSION = "0.1.0-dev"
