"""Shared lazy Redis client constructor.

PyTorch-port copy of ``mcpx/utils/redis_client.py``, used by the telemetry
mirror (``telemetry/mirror.py``). ``redis`` is imported at the first call,
never at import: the GPU machine has no ``redis`` package, and a control
plane without a mirror must import and serve there. Socket timeouts are
bounded, so an unresponsive (not refusing) Redis raises into the caller's
"the mirror is an optimisation" handling instead of hanging it.
"""

from __future__ import annotations


def lazy_redis_client(url: str, setting_name: str, *, timeout_s: float = 1.0):
    """Build an async Redis client for ``url``. Raises RuntimeError naming
    ``setting_name`` when the optional ``redis`` package is absent.

    ``timeout_s`` should match the caller's tolerance: an optional
    component (the telemetry mirror) keeps the tight default, so a stalled
    Redis degrades it instead of the serving path."""
    try:
        import redis.asyncio as aioredis  # type: ignore
    except ImportError as e:  # a machine without redis
        raise RuntimeError(
            f"{setting_name} requires the 'redis' package, which is not installed"
        ) from e
    return aioredis.from_url(
        url,
        socket_timeout=timeout_s,
        socket_connect_timeout=timeout_s,
    )
