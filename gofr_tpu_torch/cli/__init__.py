"""CLI app (reference: ``pkg/gofr/cmd.go`` + ``pkg/gofr/cmd/``).

``new_cmd()`` builds an app whose routes are regex-matched subcommands over
``sys.argv``; flags become params and bind reflectively into dataclasses
(reference ``cmd.go:27-69``, ``cmd/request.go:25-117``). Output goes to
stdout, errors to stderr (``cmd/responder.go:8-19``). Logs go to
``CMD_LOGS_FILE`` (reference ``gofr.go:99-111``).

The port's copy of ``gofr_tpu/cli/__init__.py``.
"""

from gofr_tpu_torch.cli.cmd import CMDApp, CMDRequest, CMDResponder

__all__ = ["CMDApp", "CMDRequest", "CMDResponder"]
