"""WebSocket push hub of the port's node (``/ws``)."""

from .hub import WsHub  # noqa: F401
