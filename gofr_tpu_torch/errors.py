"""Error types of the serving engine — the port's copies of the
reference's ``gofr_tpu/errors.py`` classes that ``submit_generate`` and
the request lifecycle raise.

Each carries its HTTP status in ``status_code``, as the reference's do,
so a responder maps error → status without string checks. The values
and messages are the reference's.
"""

from __future__ import annotations

from typing import Sequence


class GofrError(Exception):
    """Base class; a responder maps subclasses via ``status_code``."""

    status_code: int = 500


class ErrorInvalidParam(GofrError):
    """400 — invalid parameter(s)."""

    status_code = 400

    def __init__(self, params: Sequence[str] = ()) -> None:
        self.params = list(params)
        count = len(self.params)
        super().__init__(f"'{count}' invalid parameter(s): {', '.join(self.params)}")


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
