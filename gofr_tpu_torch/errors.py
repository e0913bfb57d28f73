"""Framework and serving error types — the port's copies of the
reference's ``gofr_tpu/errors.py`` classes: the HTTP vocabulary the
router and the responder map, and the errors ``submit_generate`` and the
request lifecycle raise.

Each carries its HTTP status in ``status_code``, as the reference's do,
so a responder maps error → status without string checks. The values
and messages are the reference's. ``ErrorNoHealthyReplica`` waits for the
replica pool (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Sequence


class GofrError(Exception):
    """Base class; a responder maps subclasses via ``status_code``."""

    status_code: int = 500


class ErrorEntityNotFound(GofrError):
    """404 — entity lookup miss."""

    status_code = 404

    def __init__(self, name: str, value: str) -> None:
        super().__init__(f"No entity found with {name}: {value}")
        self.name = name
        self.value = value


class ErrorEntityAlreadyExists(GofrError):
    status_code = 409

    def __init__(self) -> None:
        super().__init__("entity already exists")


class ErrorInvalidParam(GofrError):
    """400 — invalid parameter(s)."""

    status_code = 400

    def __init__(self, params: Sequence[str] = ()) -> None:
        self.params = list(params)
        count = len(self.params)
        super().__init__(f"'{count}' invalid parameter(s): {', '.join(self.params)}")


class ErrorMissingParam(GofrError):
    status_code = 400

    def __init__(self, params: Sequence[str] = ()) -> None:
        self.params = list(params)
        count = len(self.params)
        super().__init__(f"'{count}' missing parameter(s): {', '.join(self.params)}")


class ErrorInvalidRoute(GofrError):
    status_code = 404

    def __init__(self) -> None:
        super().__init__("route not registered")


class ErrorRequestTimeout(GofrError):
    status_code = 408

    def __init__(self) -> None:
        super().__init__("request timed out")


class ErrorPanicRecovery(GofrError):
    """500 — a handler raised an unexpected exception."""

    status_code = 500

    def __init__(self) -> None:
        super().__init__("some unexpected error has occurred")


class ErrorServiceUnavailable(GofrError):
    """503 — e.g. a submit while the engine drains for shutdown."""

    status_code = 503

    def __init__(self, dependency: str = "") -> None:
        msg = "service unavailable"
        if dependency:
            msg += f": {dependency}"
        super().__init__(msg)


class ErrorPayloadTooLarge(GofrError):
    """413 — an uploaded payload exceeds a configured store limit."""

    status_code = 413

    def __init__(self, what: str, size: int, limit: int) -> None:
        super().__init__(
            f"{what} of {size} bytes exceeds the limit of {limit} bytes"
        )


class ErrorTooManyRequests(GofrError):
    """429 — the submit queue is over a budget (load shedding). Carries a
    ``Retry-After`` estimate (whole seconds, at least 1) in
    ``retry_after_s`` and ``headers``."""

    status_code = 429

    def __init__(self, reason: str, retry_after_s: float = 1.0) -> None:
        self.retry_after_s = max(1, int(-(-retry_after_s // 1)))  # ceil >= 1
        self.headers = {"Retry-After": str(self.retry_after_s)}
        super().__init__(
            f"request shed: {reason}; retry after ~{self.retry_after_s}s"
        )


class ErrorDeadlineExceeded(GofrError):
    """504 — the request's deadline expired before (or during)
    generation. Mid-stream, the engine retires the sequence and frees its
    KV blocks; the stream ends with this terminal error."""

    status_code = 504

    def __init__(self, detail: str = "") -> None:
        msg = "deadline exceeded"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class ErrorRequestCancelled(GofrError):
    """499 (client closed request) — the caller cancelled or
    disconnected; the engine retired the sequence."""

    status_code = 499

    def __init__(self) -> None:
        super().__init__("request cancelled by the client")


class ErrorPromptTooLong(GofrError):
    """413 — the prompt exceeds the engine's serveable context window
    (truncation is opt-in: ``truncate_prompts``)."""

    status_code = 413

    def __init__(self, prompt_tokens: int, max_tokens: int) -> None:
        self.prompt_tokens = prompt_tokens
        self.max_tokens = max_tokens
        super().__init__(
            f"prompt of {prompt_tokens} tokens exceeds the maximum "
            f"serveable prompt length {max_tokens}"
        )
