"""Subscription manager (reference ``pkg/gofr/subscriber.go:13-84``).

One async task per subscribed topic, each looping: poll the broker (in a
worker thread, since broker clients block), wrap the message as the request
in a fresh Context, run the handler with panic recovery, and commit only on
success (reference ``subscriber.go:27-57,63-84``). Errors log-and-continue;
cancellation stops the loop (the graceful-shutdown hook the reference lacks).

The port's copy of ``gofr_tpu/subscriber.py``.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Callable

from gofr_tpu_torch.context import Context


class SubscriptionManager:
    def __init__(self, container) -> None:
        self._container = container
        self._subscriptions: dict[str, Callable] = {}
        self._tasks: list[asyncio.Task] = []

    def register(self, topic: str, handler: Callable) -> None:
        self._subscriptions[topic] = handler

    @property
    def topics(self) -> list[str]:
        return list(self._subscriptions)

    def start(self) -> None:
        for topic, handler in self._subscriptions.items():
            self._tasks.append(
                asyncio.get_running_loop().create_task(
                    self._run_loop(topic, handler), name=f"subscriber-{topic}"
                )
            )

    async def stop(self) -> None:
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        self._tasks.clear()

    async def _run_loop(self, topic: str, handler) -> None:
        container = self._container
        logger = container.logger
        loop = asyncio.get_running_loop()
        is_async = asyncio.iscoroutinefunction(handler)
        while True:
            subscriber = container.get_subscriber()
            if subscriber is None:
                await asyncio.sleep(1.0)
                continue
            try:
                msg = await loop.run_in_executor(None, subscriber.subscribe, topic, 0.5)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                logger.errorf("error while reading from topic %s: %s", topic, exc)
                await asyncio.sleep(0.1)  # the reference hot-loops here; back off instead
                continue
            if msg is None:
                continue
            ctx = Context(request=msg, container=container)
            try:
                if is_async:
                    err = await handler(ctx)
                else:
                    err = await loop.run_in_executor(None, handler, ctx)
            except asyncio.CancelledError:
                raise
            except Exception:
                # Panic recovery (reference subscriber.go:63-84).
                logger.errorf(
                    "subscriber handler for topic %s panicked:\n%s",
                    topic,
                    traceback.format_exc(),
                )
                continue
            if err is None or err is True:
                msg.commit()
