"""Configuration layer (reference: ``pkg/gofr/config``).

Env-var-first configuration with dotenv layering, mirroring the reference's
``config/config.go:3-6`` (two-method interface) and ``config/godotenv.go:25-79``
(``configs/.env`` loaded first, then overlaid by ``.local.env`` or
``.${APP_ENV}.env``).

The port's copy of ``gofr_tpu/config/__init__.py``.
"""

from gofr_tpu_torch.config.env import Config, EnvLoader, MockConfig, new_env_file

__all__ = ["Config", "EnvLoader", "MockConfig", "new_env_file"]
