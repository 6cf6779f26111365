"""Transport layer for invoking microservices.

PyTorch-port copy of ``mcpx/orchestrator/transport.py``. Transport is an
injected interface:

  - ``AioHttpTransport`` — real HTTP POSTs (aiohttp, pooled, lazy session;
    aiohttp is imported only inside its methods, so the control plane
    imports on a machine without it);
  - ``LocalTransport``   — in-process async endpoints under ``local://`` URLs,
    used by tests and ``chip_smoke.py`` for scriptable latency/failure
    injection without sockets;
  - ``RouterTransport``  — dispatches by URL scheme so real and local
    endpoints can coexist in one plan.

All transports raise ``TransportError`` (with a ``timeout`` flag) so the
executor's retry/fallback state machine is transport-agnostic.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Awaitable, Callable, Mapping, Optional

from mcpx_torch.core.errors import MCPXError

LocalHandler = Callable[[dict[str, Any]], Awaitable[dict[str, Any]]]


def _parse_retry_after(raw: Optional[str]) -> Optional[float]:
    """Seconds form of the Retry-After header; the HTTP-date form (rare on
    429s) is ignored rather than parsed — a backoff hint, not a contract."""
    if not raw:
        return None
    try:
        v = float(raw)
    except ValueError:
        return None
    return v if v >= 0 else None


class TransportError(MCPXError):
    def __init__(
        self,
        message: str,
        *,
        timeout: bool = False,
        status: int = 0,
        retry_after_s: Optional[float] = None,
    ) -> None:
        super().__init__(message)
        self.timeout = timeout
        self.status = status
        # Surfaced from a 429/503 Retry-After header so the executor can
        # honor it (capped against the request's remaining deadline budget).
        self.retry_after_s = retry_after_s

    @property
    def retryable(self) -> bool:
        """Whether retrying the SAME endpoint can plausibly succeed.
        Timeouts and transport/5xx failures are; a 4xx is a deterministic
        rejection of this request — except 408 (server-side timeout) and
        429 (transient throttling)."""
        if self.timeout or self.status == 0:
            return True
        return not (400 <= self.status < 500) or self.status in (408, 429)


class Transport:
    async def post(self, url: str, payload: dict[str, Any], timeout_s: float) -> dict[str, Any]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


class AioHttpTransport(Transport):
    """HTTP transport with a lazily-created pooled session (no import-time or
    construct-time sockets — reference bug B8)."""

    def __init__(self, max_connections: int = 512) -> None:
        self._max_connections = max_connections
        self._session = None

    def _get_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=self._max_connections)
            )
        return self._session

    async def post(self, url: str, payload: dict[str, Any], timeout_s: float) -> dict[str, Any]:
        import aiohttp

        session = self._get_session()
        try:
            async with session.post(
                url, json=payload, timeout=aiohttp.ClientTimeout(total=timeout_s)
            ) as resp:
                if resp.status >= 400:
                    body = (await resp.text())[:512]
                    raise TransportError(
                        f"HTTP {resp.status} from {url}: {body}",
                        status=resp.status,
                        retry_after_s=_parse_retry_after(
                            resp.headers.get("Retry-After")
                        ),
                    )
                try:
                    return await resp.json(content_type=None)
                except (json.JSONDecodeError, ValueError) as e:
                    raise TransportError(f"non-JSON response from {url}: {e}") from e
        except asyncio.TimeoutError as e:
            raise TransportError(f"timeout after {timeout_s}s calling {url}", timeout=True) from e
        except aiohttp.ClientError as e:
            raise TransportError(f"connection error calling {url}: {e}") from e

    async def close(self) -> None:
        # Detach before the await: a second close() arriving while the
        # first is mid-await sees None instead of double-closing the same
        # session (mcpxlint async-shared-mutation).
        session, self._session = self._session, None
        if session is not None:
            await session.close()


class LocalTransport(Transport):
    """In-process endpoints: ``local://service-name`` → async handler.

    Handlers may raise to simulate failures; ``latency_s`` adds scriptable
    delay per endpoint for fault/latency injection in tests and benchmarks.
    """

    def __init__(self) -> None:
        self._handlers: dict[str, LocalHandler] = {}
        self._latency: dict[str, float] = {}

    def register(self, name: str, handler: LocalHandler, latency_s: float = 0.0) -> str:
        self._handlers[name] = handler
        if latency_s:
            self._latency[name] = latency_s
        return f"local://{name}"

    async def post(self, url: str, payload: dict[str, Any], timeout_s: float) -> dict[str, Any]:
        name = url.removeprefix("local://")
        handler = self._handlers.get(name)
        if handler is None:
            raise TransportError(f"no local handler registered for {url}")
        delay = self._latency.get(name, 0.0)
        try:
            result = await asyncio.wait_for(
                self._run(handler, payload, delay), timeout=timeout_s
            )
        except asyncio.TimeoutError as e:
            raise TransportError(f"timeout after {timeout_s}s calling {url}", timeout=True) from e
        except TransportError:
            raise
        except Exception as e:
            raise TransportError(f"local handler {url} failed: {e}") from e
        if not isinstance(result, Mapping):
            raise TransportError(f"local handler {url} returned non-mapping result")
        return dict(result)

    @staticmethod
    async def _run(handler: LocalHandler, payload: dict[str, Any], delay: float) -> dict[str, Any]:
        if delay:
            await asyncio.sleep(delay)
        return await handler(payload)


class RouterTransport(Transport):
    """Scheme-based dispatch: ``local://`` → LocalTransport, else HTTP."""

    def __init__(self, local: Optional[LocalTransport] = None, http: Optional[Transport] = None):
        self.local = local or LocalTransport()
        self._http = http

    def _get_http(self) -> Transport:
        if self._http is None:
            self._http = AioHttpTransport()
        return self._http

    async def post(self, url: str, payload: dict[str, Any], timeout_s: float) -> dict[str, Any]:
        if url.startswith("local://"):
            return await self.local.post(url, payload, timeout_s)
        return await self._get_http().post(url, payload, timeout_s)

    async def close(self) -> None:
        await self.local.close()
        if self._http is not None:
            await self._http.close()
