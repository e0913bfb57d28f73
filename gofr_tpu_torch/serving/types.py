"""Serving request/result types (the port's copies of the reference's
``GenerationResult`` and of the fields of its request record that this
port serves)."""

from __future__ import annotations

import queue
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional

from gofr_tpu_torch.serving.lifecycle import CancelToken, Deadline

# Padded sequence buckets (the encoder family's batch shapes).
_PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096)

# logit_bias entries per request — the OpenAI cap. The [slots, K] planes
# upload only on admission, so K is cheap padding.
LOGIT_BIAS_K = 300


@dataclass
class GenerationResult:
    text: str
    token_ids: list[int]
    prompt_tokens: int
    ttft_s: float
    duration_s: float
    truncated: bool = False  # prompt head dropped (truncate_prompts)
    # Model log-softmax at each generated token (after logit_bias and
    # penalties: the distribution the choice was made from).
    token_logprobs: list[float] = field(default_factory=list)
    # "stop" (eos or a stop sequence matched) | "length" (token budget or
    # context window exhausted).
    finish_reason: str = "stop"
    # True when a brownout controller clamped the budget; always False
    # until the brownout controller is ported.
    brownout: bool = False
    # Per-token [(token_id, logprob), ...] alternatives when the request
    # asked for top_logprobs (None otherwise).
    token_top_logprobs: Optional[list[Optional[list[tuple[int, float]]]]] = None

    @property
    def tokens_per_sec(self) -> float:
        gen = max(len(self.token_ids), 1)
        return gen / self.duration_s if self.duration_s > 0 else 0.0


@dataclass
class GenRequest:
    """One generate request from submit to retirement. ``future`` resolves
    with the ``GenerationResult`` (or the error that retired it);
    ``stream`` carries each token id as it is emitted, then ``None``."""

    prompt_ids: list[int]
    max_new_tokens: int
    temperature: float
    stop_on_eos: bool
    seed: int
    top_p: float = 1.0
    stream: "queue.Queue[Optional[int]]" = field(default_factory=queue.Queue)
    future: Future = field(default_factory=Future)
    enqueued_at: float = field(default_factory=time.time)
    token_ids: list[int] = field(default_factory=list)
    token_logprobs: list[float] = field(default_factory=list)
    ttft_s: float = 0.0
    # Host clock (time.time()) at each emitted token; inter-token latency
    # is the difference of neighbours.
    token_times: list[float] = field(default_factory=list)
    truncated: bool = False
    # Stop sequences: generation retires early when the decoded text
    # contains one; the result is trimmed at the match.
    stop_texts: list[str] = field(default_factory=list)
    # OpenAI-style penalties over generated tokens (enable_penalties).
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # OpenAI logit_bias: {token_id: bias}, at most LOGIT_BIAS_K entries.
    logit_bias: dict[int, float] = field(default_factory=dict)
    # OpenAI top_logprobs: alternatives per emitted token (at most the
    # engine's top_logprobs).
    top_logprobs: int = 0
    token_top_logprobs: list[Optional[list[tuple[int, float]]]] = field(
        default_factory=list
    )
    # Set by the finish rule when a stop sequence matched: char offset of
    # the earliest match in the decoded text.
    stop_cut: int = -1
    # Lifecycle: the scheduler's per-pass reap retires the request (and
    # frees its slot and KV blocks) when the deadline expires or the
    # cancel token trips.
    deadline: Optional[Deadline] = None
    cancel: CancelToken = field(default_factory=CancelToken)
    # Admission-quota tenant; "" means untenanted.
    tenant: str = ""
    # SLO class (interactive | standard | batch): the admission queue's
    # dequeue priority.
    slo_class: str = "standard"
    # The caller's W3C trace context (the HTTP tracer middleware's span).
    traceparent: Optional[str] = None
    # Prompt tokens in the cache once the prefill finished (0 before): a
    # request whose prefill completed has its full prompt blocks indexed
    # by the prefix cache when it retires.
    effective_prompt_len: int = 0
    # A register_prefix request: its prefill parks the rows in the prefix
    # pool and resolves the future with the pool row; it never decodes.
    prefix_store: bool = False
    # Multi-LoRA: the adapter slot (0 = base model), the slot's load
    # generation at submit (a request whose adapter was reloaded or
    # unloaded since must not run under the new weights) and the
    # adapter's name.
    aid: int = 0
    lora_gen: int = 0
    adapter: str = ""

    def cancel_request(self) -> None:
        """Transport-side cancel (client disconnect, abandoned stream):
        trips the token the scheduler reaps on and cancels the future, so
        a request not yet admitted resolves at once."""
        self.cancel.cancel()
        self.future.cancel()
