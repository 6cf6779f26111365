"""HTTP API surface (aiohttp) of the PyTorch port.

PyTorch-port copy of the serving routes of ``mcpx/server/app.py``, with the
same bodies, status codes and JSON errors:

  POST /plan              {"intent": str} -> {"graph", "explanation", "origin", "latency_ms"}
  POST /execute           {"graph": {...}, "payload": {...}} -> {"results", "errors", "status", "trace"}
  POST /plan_and_execute  {"intent": str, "payload": {...}} -> plan + execution + replans
  GET/POST /services, GET/DELETE /services/{name}   registry CRUD
  GET  /cache      plan cache and radix prefix cache counters
  GET  /telemetry  per-service rolling stats snapshot
  GET  /healthz    liveness + engine readiness

The middleware keeps the reference's admission limit (429 at
``server.max_concurrency`` on the three serving paths), the request timeout
(504 at ``server.request_timeout_s``, which cancels the engine future so the
worker frees the row), an ``X-Trace-Id`` header on every response and
JSON-only 500s. Not ported yet: ``traceparent``, ``/metrics``, ``/costs``,
``/traces``, ``/explain``, ``/usage``, ``/slo``, ``/cluster``, ``/debug/*``
and ``/profile/*``.

This is the one module of the port that imports aiohttp; nothing on the
``ControlPlane`` path imports it. Serve with ``python -m
mcpx_torch.server.app --config cfg.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
from typing import Any, Optional

from aiohttp import web

from mcpx_torch import __version__
from mcpx_torch.core.dag import Plan, PlanValidationError
from mcpx_torch.core.errors import PlannerError, RegistryError
from mcpx_torch.core.trace import new_trace_id
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.server.control import ControlPlane

log = logging.getLogger("mcpx_torch.server")

TRACE_ID_KEY = "mcpx_trace_id"

# Endpoints subject to the server.max_concurrency admission limit (the
# planning/execution paths; observability and CRUD stay always-available).
_LIMITED = frozenset({"/plan", "/execute", "/plan_and_execute"})

# Routes whose error bodies carry no trace id: the reference never opens a
# request trace for its observability surfaces.
_UNTRACED = frozenset({"/cache", "/healthz", "/telemetry"})


def _json_error(
    request: web.Request, status: int, message: str, **extra: Any
) -> web.Response:
    """Error envelope. Carries the request's trace id (the ``X-Trace-Id``
    header's) wherever the reference would have an active request trace:
    tracing on and a traced route."""
    tid = request.get(TRACE_ID_KEY)
    if tid is not None and "trace_id" not in extra:
        extra["trace_id"] = tid
    return web.json_response({"error": message, **extra}, status=status)


async def _body(request: web.Request) -> dict[str, Any]:
    try:
        obj = await request.json()
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise web.HTTPBadRequest(
            text=json.dumps({"error": f"invalid JSON body: {e}"}),
            content_type="application/json",
        )
    if not isinstance(obj, dict):
        raise web.HTTPBadRequest(
            text=json.dumps({"error": "request body must be a JSON object"}),
            content_type="application/json",
        )
    return obj


def build_app(cp: ControlPlane) -> web.Application:
    server_cfg = cp.config.server
    inflight = {"n": 0}

    def _tenant_of(request: web.Request) -> str:
        """Cache-governance tenant: the scheduler-config tenant header (the
        reference's name for it whether or not a scheduler runs). Absent
        header = single-tenant "default"."""
        return request.headers.get(cp.config.scheduler.tenant_header) or "default"

    @web.middleware
    async def limits(request: web.Request, handler) -> web.StreamResponse:
        """Every request: a trace ID, admission control (429) and a hard
        request timeout (504); errors are always JSON."""
        resource = getattr(request.match_info.route, "resource", None)
        endpoint = resource.canonical if resource is not None else "unmatched"
        trace_id = new_trace_id()
        if cp.config.tracing.enabled and endpoint not in _UNTRACED and endpoint != "unmatched":
            request[TRACE_ID_KEY] = trace_id
        limited = request.path in _LIMITED
        if limited and inflight["n"] >= server_cfg.max_concurrency:
            return _json_error(request, 429, "server at max concurrency, retry later")
        if limited:
            inflight["n"] += 1
        try:
            resp = await asyncio.wait_for(handler(request), timeout=server_cfg.request_timeout_s)
        except asyncio.TimeoutError:
            return _json_error(request, 504, f"request exceeded {server_cfg.request_timeout_s}s")
        except web.HTTPException:
            raise
        except Exception as e:  # errors must be JSON, never HTML
            log.exception("unhandled error on %s", endpoint)
            return _json_error(request, 500, f"{type(e).__name__}: {e}")
        finally:
            if limited:
                inflight["n"] -= 1
        resp.headers["X-Trace-Id"] = trace_id
        return resp

    app = web.Application(client_max_size=16 * 1024 * 1024, middlewares=[limits])

    # ------------------------------------------------------------------ plan
    async def plan(request: web.Request) -> web.Response:
        body = await _body(request)
        intent = body.get("intent")
        if not isinstance(intent, str) or not intent.strip():
            return _json_error(request, 400, "'intent' must be a non-empty string")
        try:
            p, latency_ms = await cp.plan(intent, tenant=_tenant_of(request))
        except PlannerError as e:
            return _json_error(request, 422, f"planning failed: {e}")
        return web.json_response({
            "graph": p.to_wire(),
            "explanation": p.explanation,
            # Which planner authored the plan ("llm" | "heuristic").
            "origin": p.origin,
            "latency_ms": round(latency_ms, 3),
        })

    # --------------------------------------------------------------- execute
    async def execute(request: web.Request) -> web.Response:
        body = await _body(request)
        graph = body.get("graph")
        payload = body.get("payload", {})
        if payload is None:
            payload = {}
        if not isinstance(graph, dict):
            return _json_error(request, 400, "'graph' must be an object")
        if not isinstance(payload, dict):
            return _json_error(request, 400, "'payload' must be an object")
        try:
            plan_obj = Plan.from_wire(graph)
        except PlanValidationError as e:
            return _json_error(request, 422, "invalid graph", problems=e.problems)
        result = await cp.execute(plan_obj, payload)
        return web.json_response(result.to_dict())

    # ------------------------------------------------------ plan_and_execute
    async def plan_and_execute(request: web.Request) -> web.Response:
        body = await _body(request)
        intent = body.get("intent")
        payload = body.get("payload", {})
        if payload is None:
            payload = {}
        if not isinstance(intent, str) or not intent.strip():
            return _json_error(request, 400, "'intent' must be a non-empty string")
        if not isinstance(payload, dict):
            return _json_error(request, 400, "'payload' must be an object")
        try:
            out = await cp.plan_and_execute(intent, payload, tenant=_tenant_of(request))
        except PlannerError as e:
            return _json_error(request, 422, f"planning failed: {e}")
        return web.json_response(out)

    # -------------------------------------------------------------- registry
    async def list_services(request: web.Request) -> web.Response:
        records = await cp.registry.list_services()
        return web.json_response(
            {"services": [r.to_dict() for r in records], "version": await cp.registry.version()}
        )

    async def register_service(request: web.Request) -> web.Response:
        body = await _body(request)
        try:
            record = ServiceRecord.from_dict(body)
        except RegistryError as e:
            return _json_error(request, 400, str(e))
        await cp.registry.put(record)
        return web.json_response({"registered": record.name}, status=201)

    async def get_service(request: web.Request) -> web.Response:
        record = await cp.registry.get(request.match_info["name"])
        if record is None:
            return _json_error(request, 404, f"no such service '{request.match_info['name']}'")
        return web.json_response(record.to_dict())

    async def delete_service(request: web.Request) -> web.Response:
        existed = await cp.registry.delete(request.match_info["name"])
        if not existed:
            return _json_error(request, 404, f"no such service '{request.match_info['name']}'")
        return web.json_response({"deleted": request.match_info["name"]})

    # --------------------------------------------------------- observability
    async def cache_handler(request: web.Request) -> web.Response:
        return web.json_response(cp.cache_stats())

    async def telemetry_handler(request: web.Request) -> web.Response:
        return web.json_response({name: s.to_dict() for name, s in cp.telemetry.snapshot().items()})

    async def healthz(request: web.Request) -> web.Response:
        engine = getattr(cp.planner, "engine", None)
        engine_state = getattr(engine, "state", "n/a") if engine is not None else "n/a"
        body: dict[str, Any] = {"status": "ok", "version": __version__, "engine": engine_state}
        if engine_state == "ready":
            # Engine load snapshot: nested blocks (the kernel launch
            # counts) pass through; numbers become plain JSON ones.
            body["engine_queue"] = {
                k: (v if isinstance(v, dict) else round(float(v), 3) if isinstance(v, float) else int(v))
                for k, v in engine.queue_stats().items()
            }
        # Surface the startup failure cause (e.g. a device OOM string).
        err = getattr(engine, "_startup_error", None) if engine is not None else None
        if err is not None:
            body["engine_error"] = f"{type(err).__name__}: {err}"
        return web.json_response(body)

    app.router.add_post("/plan", plan)
    app.router.add_post("/execute", execute)
    app.router.add_post("/plan_and_execute", plan_and_execute)
    app.router.add_get("/services", list_services)
    app.router.add_post("/services", register_service)
    app.router.add_get("/services/{name}", get_service)
    app.router.add_delete("/services/{name}", delete_service)
    app.router.add_get("/cache", cache_handler)
    app.router.add_get("/telemetry", telemetry_handler)
    app.router.add_get("/healthz", healthz)

    startup_task: dict[str, asyncio.Task] = {}

    async def on_startup(app: web.Application) -> None:
        # Engine bring-up runs as a background task, not inline: on_startup
        # fires before the listening socket binds, so awaiting it here would
        # leave /healthz connection-refused the whole time. Requests that
        # arrive while warming wait inside engine.start(), which coalesces
        # concurrent callers.
        startup_task["t"] = asyncio.create_task(cp.startup())

    async def on_cleanup(app: web.Application) -> None:
        t = startup_task.pop("t", None)
        if t is not None:
            if not t.done():
                t.cancel()
            try:
                await t
            except asyncio.CancelledError:
                pass  # shutdown raced a still-warming engine; expected
            except Exception:
                # Startup failures already surface via engine.state and
                # /healthz; debug-log so shutdown stays quiet but traceable.
                log.debug("engine startup task ended with an error", exc_info=True)
        await cp.aclose()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def main(argv: Optional[list[str]] = None) -> int:
    """Serve the port's API: ``python -m mcpx_torch.server.app [--config
    cfg.json] [--port N] [--device cpu]`` (the device defaults to CUDA)."""
    from mcpx_torch.core.config import MCPXConfig
    from mcpx_torch.server.factory import build_control_plane

    ap = argparse.ArgumentParser(description="Serve the mcpx_torch HTTP API.")
    ap.add_argument("--config", help="JSON file of MCPXConfig sections")
    ap.add_argument("--port", type=int, default=0, help="overrides server.port")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    raw: dict = {}
    if args.config:
        with open(args.config) as f:
            raw = json.load(f)
    cfg = MCPXConfig.from_dict(raw)
    if args.port:
        cfg.server.port = args.port
    cp = build_control_plane(cfg, device=args.device)
    web.run_app(build_app(cp), host=cfg.server.host, port=cfg.server.port)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
