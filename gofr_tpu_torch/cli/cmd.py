"""CLI transport: regex subcommand routing + flag parsing.

Reference behavior: non-flag args joined into the command string, first
route whose regex matches wins (``cmd.go:32-62``); flags ``-a=b`` / ``--x``
/ ``-bool`` parsed into params (``cmd/request.go:25-67``); ``bind`` maps
params into a dataclass (``cmd/request.go:89-117``); data → stdout, errors →
stderr with exit code (``cmd/responder.go:8-19``).

The port's copy of ``gofr_tpu/cli/cmd.py``.
"""

from __future__ import annotations

import json
import re
import sys
from typing import Any, Callable, Optional

from gofr_tpu_torch.config.env import new_env_file
from gofr_tpu_torch.container import Container
from gofr_tpu_torch.context import Context
from gofr_tpu_torch.logging import new_file_logger


class CMDRequest:
    """Request over argv (reference ``cmd/request.go:14-117``)."""

    def __init__(self, args: list[str]) -> None:
        self._args = args
        self._params: dict[str, str] = {}
        positional: list[str] = []
        for arg in args:
            if arg in ("-", "--", ""):
                continue
            if arg.startswith("-"):
                name = arg.lstrip("-")
                if "=" in name:
                    key, _, value = name.partition("=")
                    self._params[key] = value
                else:
                    self._params[name] = "true"
            else:
                positional.append(arg)
        self.command = " ".join(positional)

    def param(self, key: str) -> str:
        return self._params.get(key, "")

    def path_param(self, key: str) -> str:
        return self.param(key)

    def params(self, key: str) -> list[str]:
        val = self.param(key)
        return val.split(",") if val else []

    @property
    def body(self) -> bytes:
        return b""

    def bind(self, target: Any) -> Any:
        """Reflective param→field bind (reference ``cmd/request.go:89-117``)."""
        from gofr_tpu_torch.http.request import _fill

        return _fill(target, dict(self._params))

    def host_name(self) -> str:
        import socket

        return socket.gethostname()


class CMDResponder:
    """data → stdout, error → stderr (reference ``cmd/responder.go:8-19``)."""

    def __init__(self, out=None, err=None) -> None:
        self._out = out or sys.stdout
        self._err = err or sys.stderr
        self.exit_code = 0

    def respond(self, result: Any, error: Optional[BaseException]) -> None:
        if error is not None:
            self._err.write(f"{error}\n")
            self.exit_code = 1
        if result is not None:
            if isinstance(result, (dict, list)):
                self._out.write(json.dumps(result, default=str) + "\n")
            else:
                self._out.write(f"{result}\n")


class CMDApp:
    """Subcommand app (reference ``cmd.go:27-51`` + ``gofr.go:99-111``)."""

    def __init__(self, config_dir: str = "./configs", config=None) -> None:
        self.config = config if config is not None else new_env_file(config_dir)
        log_file = self.config.get_or_default("CMD_LOGS_FILE", "")
        logger = new_file_logger(log_file)
        self.container = Container.create(self.config, logger=logger)
        self.logger = logger
        self._routes: list[tuple[re.Pattern, Callable, str]] = []

    def sub_command(self, pattern: str, handler: Optional[Callable] = None, description: str = ""):
        """Register a regex-matched subcommand (reference ``cmd.go:65-69``)."""
        if handler is not None:
            self._routes.append((re.compile(pattern), handler, description))
            return handler

        def decorator(fn: Callable):
            self._routes.append((re.compile(pattern), fn, description))
            return fn

        return decorator

    def run(self, argv: Optional[list[str]] = None, out=None, err=None) -> int:
        args = list(sys.argv[1:] if argv is None else argv)
        request = CMDRequest(args)
        responder = CMDResponder(out=out, err=err)

        handler = None
        for pattern, fn, _desc in self._routes:
            if pattern.search(request.command):
                handler = fn
                break
        if handler is None:
            responder.respond(None, Exception("No Command Found!"))
            return responder.exit_code

        ctx = Context(request=request, container=self.container)
        try:
            result = handler(ctx)
            responder.respond(result, None)
        except Exception as exc:
            responder.respond(None, exc)
        return responder.exit_code
