"""Inter-service HTTP client (reference: ``pkg/gofr/service``, ~1,061 LoC).

Decorator-pattern client: ``new_http_service(addr, logger, metrics,
*options)`` folds ``Option`` wrappers over a base client (reference
``service/new.go:68-87``, ``service/options.go:3-5``). Options: circuit
breaker, health config, retries, API-key/basic/OAuth auth, default headers.

The port's copy of ``gofr_tpu/service``. The replica tier
(``ReplicaPool``, ``EngineReplica``, ``HTTPReplica``, ``PoolScaler``)
stays with ROADMAP Queue 1 item 7.5.
"""

from gofr_tpu_torch.service.client import HTTPService, Response, new_http_service
from gofr_tpu_torch.service.circuit_breaker import (
    CircuitBreakerConfig,
    CircuitOpenError,
)
from gofr_tpu_torch.service.options import (
    APIKeyConfig,
    BasicAuthConfig,
    DefaultHeaders,
    HealthConfig,
    OAuthConfig,
    RetryConfig,
)

__all__ = [
    "HTTPService",
    "Response",
    "new_http_service",
    "CircuitBreakerConfig",
    "CircuitOpenError",
    "APIKeyConfig",
    "BasicAuthConfig",
    "OAuthConfig",
    "DefaultHeaders",
    "HealthConfig",
    "RetryConfig",
]
