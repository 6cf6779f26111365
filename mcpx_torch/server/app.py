"""HTTP API surface (aiohttp) of the PyTorch port.

PyTorch-port copy of the serving routes of ``mcpx/server/app.py``, with the
same bodies, status codes and JSON errors:

  POST /plan              {"intent": str} -> {"graph", "explanation", "origin", "latency_ms"
                          [, "planner": "primary" | "degraded" with a scheduler]}
  POST /execute           {"graph": {...}, "payload": {...}} -> {"results", "errors", "status", "trace"}
  POST /plan_and_execute  {"intent": str, "payload": {...}} -> plan + execution + replans
  GET/POST /services, GET/DELETE /services/{name}   registry CRUD
  GET  /cache      plan cache and radix prefix cache counters
  GET  /telemetry  per-service rolling stats snapshot
  GET  /healthz    liveness + engine readiness
  GET  /metrics    Prometheus text exposition (OpenMetrics, with exemplar
                   trace ids, on ``Accept: application/openmetrics-text``)
  GET  /costs      per-executable analytic costs, the capture sentinel's
                   compile counts, device peaks and HBM stats
  GET  /traces, GET /traces/{trace_id}   retained request traces (JSON, or
                   Chrome trace-event JSON with ``?format=chrome``)
  POST /profile/start, /profile/stop   a torch.profiler trace of live
                   serving, written as a Chrome trace into the directory
  GET  /explain/{trace_id}   a retained trace's decision trail (structured
                   and as a narrative)
  GET  /debug/anomalies, GET /debug/anomalies/{bundle_id}   the flight
                   recorder's detectors, bundle index and bundles
  GET  /usage      the cost ledger's per-tenant usage and recent bills
  GET  /slo        the SLO error budgets, global and per tenant
  GET  /cluster    the replica pool's scoreboard, decision ring and journal

The ``observability`` middleware is the reference's: a root span per
request (W3C ``traceparent`` in and out, ``X-Trace-Id`` equal to the
trace's id), ``mcpx_requests_total`` and ``mcpx_request_latency_seconds``
(an exemplar only for a kept trace), the admission limit (429 at
``server.max_concurrency`` on the three serving paths), the request timeout
(504 at ``server.request_timeout_s``, which cancels the engine future so the
worker frees the row) and JSON-only 500s. With a scheduler attached
(``cp.scheduler``, read per request) ``/plan`` acquires a slot under a
``sched.acquire`` span first: a shed is a 429 with ``Retry-After``, and a
degraded grant is served by the shortlist planner. With resilience wired
``/execute`` reads the deadline header into the request's budget. On the
three serving paths the middleware also runs telemetry's default-off
parts, each read per request so it can be attached live: it activates a
``RequestBill`` (the handlers and the engine add their items; the bill is
finalized onto the root span and into ``ledger.observe``), begins and ends
a provenance trail, and feeds ``slo.observe`` (not for a 429). A disabled
part's route answers ``{"enabled": false}`` (``/usage``, ``/slo``,
``/debug/anomalies``, ``/cluster``) or 404 (a bundle). ``GET /cluster``
serves the replica pool's scoreboard. The mirror's sync loop, the flight
recorder's sampling loop and the pool's scoreboard refresh run from startup
to cleanup.

This is the one module of the port that imports aiohttp; nothing on the
``ControlPlane`` path imports it. Serve with ``python -m
mcpx_torch.server.app --config cfg.json``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import torch
from aiohttp import web

from mcpx_torch import __version__
from mcpx_torch.core.dag import Plan, PlanValidationError
from mcpx_torch.core.errors import PlannerError, RegistryError
from mcpx_torch.core.trace import new_trace_id
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.scheduler.admission import ShedError
from mcpx_torch.server.control import ControlPlane
from mcpx_torch.telemetry import ledger as ledger_mod
from mcpx_torch.telemetry import metrics as metrics_mod
from mcpx_torch.telemetry import provenance, tracing
from mcpx_torch.telemetry.costs import device_peaks, hbm_stats, update_hbm_gauges

log = logging.getLogger("mcpx_torch.server")

TRACE_ID_KEY = "mcpx_trace_id"

# Endpoints subject to the server.max_concurrency admission limit (the
# planning/execution paths; observability and CRUD stay always-available).
_LIMITED = metrics_mod.LIMITED_ENDPOINTS

# Observability surfaces are never traced (by route template): a scraper
# polling /metrics or an operator paging through /traces would otherwise
# flush the ring with traces of the observability itself. The reference's
# set, its /cluster route included.
_UNTRACED = frozenset({
    "/metrics", "/costs", "/cache", "/traces", "/traces/{trace_id}",
    "/healthz", "/telemetry", "/debug/anomalies",
    "/debug/anomalies/{bundle_id}", "/usage", "/slo", "/cluster",
    "/explain/{trace_id}",
})


# Request key the /plan handler sets to tell the middleware's SLO observe
# of a degraded grant when no ledger bill is active.
DEGRADED_KEY = "mcpx_degraded"


def _json_error(status: int, message: str, *, headers: Any = None, **extra: Any) -> web.Response:
    """Error envelope. Carries the active trace's id, so a reported failure
    line leads straight to its trace at ``GET /traces/{id}``."""
    tid = tracing.current_trace_id()
    if tid is not None and "trace_id" not in extra:
        extra["trace_id"] = tid
    return web.json_response({"error": message, **extra}, status=status, headers=headers)


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
    metrics = cp.metrics
    server_cfg = cp.config.server
    inflight = {"n": 0}

    def _tenant_of(request: web.Request) -> str:
        """Cache-governance tenant: the scheduler-config tenant header (the
        reference's name for it whether or not a scheduler runs). Absent
        header = single-tenant "default"."""
        return request.headers.get(cp.config.scheduler.tenant_header) or "default"

    @web.middleware
    async def observability(request: web.Request, handler) -> web.StreamResponse:
        """Every request: a root tracing span (W3C ``traceparent`` in and
        out), a trace ID, the request counter and latency histogram (with an
        exemplar trace id), admission control (429) and a hard request
        timeout (504); errors are always JSON."""
        # Label by route template, not raw path: bounded metric cardinality.
        resource = getattr(request.match_info.route, "resource", None)
        endpoint = resource.canonical if resource is not None else "unmatched"
        # Read per request, so a tracer can be swapped on a live server.
        tracer = cp.tracer
        root = (
            tracer.start_request(
                endpoint, traceparent=request.headers.get("traceparent"), method=request.method
            )
            if endpoint not in _UNTRACED
            else None
        )
        trace_id = root.record.trace_id if root is not None else new_trace_id()
        request[TRACE_ID_KEY] = trace_id
        t0 = time.monotonic()
        limited = request.path in _LIMITED
        # One bill per serving-path request while a ledger is attached: it
        # rides a contextvar through the handler's task, and the finalize
        # below folds it into the usage ledger and the root span.
        ledger = cp.ledger
        bill = bill_token = None
        if ledger is not None and limited:
            bill = ledger_mod.RequestBill(tenant=_tenant_of(request), endpoint=endpoint, t0=t0)
            bill_token = ledger_mod.activate(bill)
        # The provenance trail (begin() is None while the recorder is off).
        prov_token = provenance.begin(cp.provenance) if root is not None and limited else None
        status = "error"
        # Only server faults (5xx, timeouts) are always kept: a stream of
        # client 4xx must not flush the ring of the rare 5xx traces.
        http_status = 500
        try:
            with tracing.activate(root):
                if limited and inflight["n"] >= server_cfg.max_concurrency:
                    status = "throttled"
                    http_status = 429
                    return _json_error(429, "server at max concurrency, retry later")
                if limited:
                    inflight["n"] += 1
                try:
                    resp = await asyncio.wait_for(handler(request), timeout=server_cfg.request_timeout_s)
                except asyncio.TimeoutError:
                    status = "timeout"
                    http_status = 504
                    return _json_error(504, f"request exceeded {server_cfg.request_timeout_s}s")
                except web.HTTPException as he:
                    status = "ok" if he.status < 400 else "error"
                    http_status = he.status
                    raise
                except Exception as e:  # errors must be JSON, never HTML
                    status = "error"
                    http_status = 500
                    log.exception("unhandled error on %s", endpoint)
                    return _json_error(500, f"{type(e).__name__}: {e}")
                finally:
                    if limited:
                        inflight["n"] -= 1  # mcpx: ignore[async-shared-mutation] - balanced dec of the inc above; int ops don't yield, so no lost update on one loop
                status = "ok" if resp.status < 400 else "error"
                http_status = resp.status
                resp.headers["X-Trace-Id"] = trace_id
                if root is not None:
                    resp.headers["traceparent"] = tracing.format_traceparent(root)
                return resp
        finally:
            provenance.end(prov_token)
            if root is not None:
                root.set(status=status)
            elapsed_s = time.monotonic() - t0  # mcpx: ignore[span-across-await-blocking] - the latency metric must exist when tracing is disabled or the trace unsampled
            if bill is not None:
                ledger_mod.deactivate(bill_token)
                bill.finalize(status=status, total_ms=elapsed_s * 1e3)
                if root is not None:
                    # The itemized bill rides the root span (set before
                    # finish, so a retained trace carries it).
                    root.set(bill=bill.to_dict())
                ledger.observe(bill)
            slo = cp.slo
            if slo is not None and limited and http_status != 429:
                # Served requests only: a shed or throttled 429 is the load
                # shedder doing its job, not served quality.
                slo.observe(
                    tenant=bill.tenant if bill is not None else _tenant_of(request),
                    endpoint=endpoint,
                    latency_ms=elapsed_s * 1e3,
                    error=status == "timeout" or http_status >= 500,
                    degraded=bill.degraded if bill is not None else bool(request.get(DEGRADED_KEY, False)),
                )
            # Retention is decided before the histogram observation, so the
            # exemplar only ever names a trace GET /traces/{id} can serve.
            kept = tracer.finish(root, error=status == "timeout" or http_status >= 500)
            metrics.requests.labels(endpoint=endpoint, status=status).inc()
            exemplar = {"trace_id": trace_id} if kept and cp.config.tracing.exemplars else None
            metrics.request_latency.labels(endpoint=endpoint).observe(elapsed_s, exemplar=exemplar)

    app = web.Application(client_max_size=16 * 1024 * 1024, middlewares=[observability])

    # ------------------------------------------------------------------ plan
    async def plan(request: web.Request) -> web.Response:
        body = await _body(request)
        intent = body.get("intent")
        if not isinstance(intent, str) or not intent.strip():
            return _json_error(400, "'intent' must be a non-empty string")
        # The admission scheduler, read per request so it can be attached
        # to a live server. None is the pass-through path, responses
        # included (no "planner" field).
        sched = cp.scheduler
        slot = None
        if sched is not None:
            ctx = sched.context_from_headers(request.headers)
            with tracing.span("sched.acquire", tenant=ctx.tenant, weight=ctx.weight) as ssp:
                try:
                    slot = await sched.acquire(ctx)
                except ShedError as e:
                    # The trace says which gate refused (rate, queue or
                    # deadline).
                    if ssp is not None:
                        ssp.set(verdict=e.outcome, retry_after_s=e.retry_after_s)
                    provenance.emit(
                        "sched", f"shed ({e.outcome})", signals={"retry_after_s": e.retry_after_s},
                        tenant=ctx.tenant, weight=ctx.weight,
                    )
                    return _json_error(
                        429, f"admission refused: {e}", retry_after_s=e.retry_after_s,
                        headers={"Retry-After": e.retry_after_header()},
                    )
                if ssp is not None:
                    # The queue wait and the ladder's tier, picked at grant
                    # time.
                    ssp.set(
                        verdict="degraded" if slot.degraded else "admitted",
                        queue_wait_ms=round(slot.queue_wait_s * 1e3, 3),
                    )
                provenance.emit(
                    "sched",
                    "admitted to degraded tier (shortlist planner)" if slot.degraded else "admitted (primary tier)",
                    alternatives=["admitted", "degraded", "shed"],
                    signals={"queue_wait_ms": round(slot.queue_wait_s * 1e3, 3)},
                    tenant=slot.ctx.tenant,
                    weight=ctx.weight,
                )
        bill = ledger_mod.current_bill()
        if slot is not None:
            if bill is not None:
                # The grant's queue wait, tenant (what every downstream quota
                # charges) and tier become bill items.
                bill.sched_queue_ms += slot.queue_wait_s * 1e3
                bill.tenant = slot.ctx.tenant
                bill.degraded = slot.degraded
            if slot.degraded:
                # The SLO plan-quality observe needs the verdict without a
                # ledger too.
                request[DEGRADED_KEY] = True
        # The engine wall before the plan: the plan latency less what the
        # engine billed meanwhile is the planner's own overhead.
        eng0 = bill.engine_wall_ms() if bill is not None else 0.0
        try:
            p, latency_ms = await cp.plan(
                intent,
                degraded=slot.degraded if slot is not None else False,
                # The grant's EDF deadline rides to the engine's locality
                # sort; its tenant (else the tenant header) to the cache
                # governor.
                deadline_at=slot.ctx.deadline_at if slot is not None else None,
                tenant=slot.ctx.tenant if slot is not None else _tenant_of(request),
            )
        except PlannerError as e:
            return _json_error(422, f"planning failed: {e}")
        finally:
            if slot is not None:
                sched.release(slot)
        if bill is not None:
            bill.note_plan(latency_ms, bill.engine_wall_ms() - eng0)
            bill.origin = p.origin or ""
        resp = {
            "graph": p.to_wire(),
            "explanation": p.explanation,
            # Which planner authored the plan ("llm" | "heuristic").
            "origin": p.origin,
            "latency_ms": round(latency_ms, 3),
        }
        if slot is not None:
            # The ladder's tier: "primary" (the configured planner) or
            # "degraded" (the shortlist planner under sustained overload).
            resp["planner"] = "degraded" if slot.degraded else "primary"
        return web.json_response(resp)

    # --------------------------------------------------------------- execute
    async def execute(request: web.Request) -> web.Response:
        body = await _body(request)
        graph = body.get("graph")
        payload = body.get("payload", {})
        if payload is None:
            payload = {}
        if not isinstance(graph, dict):
            return _json_error(400, "'graph' must be an object")
        if not isinstance(payload, dict):
            return _json_error(400, "'payload' must be an object")
        try:
            plan_obj = Plan.from_wire(graph)
        except PlanValidationError as e:
            return _json_error(422, "invalid graph", problems=e.problems)
        # The deadline header becomes the request's attempt budget, read
        # only while resilience is wired: without it the header is not
        # parsed and this path is the pass-through.
        deadline_ms = None
        if cp.orchestrator.resilience is not None:
            raw = request.headers.get(cp.config.resilience.deadline_header)
            if raw:
                try:
                    deadline_ms = float(raw)
                except ValueError:
                    pass  # scheduling hints never 400 a valid graph
        bill = ledger_mod.current_bill()
        t_ex = time.monotonic() if bill is not None else 0.0
        result = await cp.execute(plan_obj, payload, deadline_ms=deadline_ms)
        if bill is not None:
            # The DAG's wall and the attempt counts by kind.
            bill.add_tools(result.trace.to_dict() if result.trace else None, (time.monotonic() - t_ex) * 1e3)
        return web.json_response(result.to_dict())

    # ------------------------------------------------------ plan_and_execute
    async def plan_and_execute(request: web.Request) -> web.Response:
        body = await _body(request)
        intent = body.get("intent")
        payload = body.get("payload", {})
        if payload is None:
            payload = {}
        if not isinstance(intent, str) or not intent.strip():
            return _json_error(400, "'intent' must be a non-empty string")
        if not isinstance(payload, dict):
            return _json_error(400, "'payload' must be an object")
        bill = ledger_mod.current_bill()
        eng0 = bill.engine_wall_ms() if bill is not None else 0.0
        t_ex = time.monotonic() if bill is not None else 0.0
        try:
            out = await cp.plan_and_execute(intent, payload, tenant=_tenant_of(request))
        except PlannerError as e:
            return _json_error(422, f"planning failed: {e}")
        if bill is not None:
            # One program: the engine items folded in while planning and
            # replanning; the rest of its wall (tools, replan overhead) is
            # the tool item, with the trace's attempt counts.
            bill.origin = str(out.get("origin") or "")
            wall_ms = (time.monotonic() - t_ex) * 1e3
            bill.add_tools(out.get("trace"), max(0.0, wall_ms - (bill.engine_wall_ms() - eng0)))
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
            return _json_error(400, str(e))
        await cp.registry.put(record)
        return web.json_response({"registered": record.name}, status=201)

    async def get_service(request: web.Request) -> web.Response:
        record = await cp.registry.get(request.match_info["name"])
        if record is None:
            return _json_error(404, f"no such service '{request.match_info['name']}'")
        return web.json_response(record.to_dict())

    async def delete_service(request: web.Request) -> web.Response:
        existed = await cp.registry.delete(request.match_info["name"])
        if not existed:
            return _json_error(404, f"no such service '{request.match_info['name']}'")
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

    async def metrics_handler(request: web.Request) -> web.Response:
        # HBM gauges refresh at scrape time, only from a ready engine: a
        # cold or warming one has not set its device up.
        engine = getattr(cp.planner, "engine", None)
        if engine is not None and getattr(engine, "state", None) == "ready":
            update_hbm_gauges(cp.metrics)
        if cp.slo is not None:
            # The mcpx_slo_* gauges refresh at scrape time too.
            cp.slo.update_gauges(cp.metrics)
        # OpenMetrics on request (Accept negotiation): the exposition that
        # renders the exemplar trace ids the latency histograms carry.
        if "application/openmetrics-text" in request.headers.get("Accept", ""):
            return web.Response(
                body=cp.metrics.render(openmetrics=True),
                headers={"Content-Type": metrics_mod.OPENMETRICS_CONTENT_TYPE},
            )
        return web.Response(body=cp.metrics.render(), content_type="text/plain", charset="utf-8")

    async def traces_handler(request: web.Request) -> web.Response:
        """Retained trace summaries, newest first."""
        return web.json_response({"traces": [r.summary() for r in cp.tracer.traces()]})

    async def trace_get(request: web.Request) -> web.Response:
        tid = request.match_info["trace_id"]
        rec = cp.tracer.get(tid)
        if rec is None:
            return _json_error(404, f"no trace '{tid}' (evicted, unsampled, or never existed)")
        if request.query.get("format") == "chrome":
            # Chrome trace-event JSON: loads in Perfetto / chrome://tracing.
            return web.json_response(rec.to_chrome())
        return web.json_response(rec.to_dict())

    async def explain_handler(request: web.Request) -> web.Response:
        """A retained trace's decision trail (``telemetry/provenance.py``):
        its ``decision.*`` spans as structured JSON and a narrative, in
        request order. A trace recorded with provenance off answers with an
        empty trail and says so."""
        tid = request.match_info["trace_id"]
        rec = cp.tracer.get(tid)
        if rec is None:
            return _json_error(404, f"no trace '{tid}' (evicted, unsampled, or never existed)")
        return web.json_response(provenance.build_explanation(rec))

    async def anomalies_handler(request: web.Request) -> web.Response:
        """The flight recorder's status: detector states, bundle index, the
        latest snapshot; ``enabled: false`` while it is off."""
        if cp.flight is None:
            return web.json_response({"enabled": False, "detectors": {}, "bundles": []})
        return web.json_response(cp.flight.status())

    async def anomaly_bundle_handler(request: web.Request) -> web.Response:
        """One diagnostic bundle by id, read off the event loop."""
        if cp.flight is None:
            return _json_error(404, "flight recorder disabled")
        bid = request.match_info["bundle_id"]
        bundle = await cp.flight.load_bundle(bid)
        if bundle is None:
            return _json_error(404, f"no bundle '{bid}' (pruned or never captured)")
        return web.json_response(bundle)

    async def usage_handler(request: web.Request) -> web.Response:
        """The cost ledger's per-tenant usage and recent bills."""
        if cp.ledger is None:
            return web.json_response({"enabled": False})
        return web.json_response(cp.ledger.snapshot())

    async def slo_handler(request: web.Request) -> web.Response:
        """The SLO error budgets, with a gauge refresh so ``/metrics``
        agrees with what this served."""
        if cp.slo is None:
            return web.json_response({"enabled": False})
        cp.slo.update_gauges(cp.metrics)
        return web.json_response(cp.slo.status())

    async def cluster_handler(request: web.Request) -> web.Response:
        """The replica pool's scoreboard: per-replica lifecycle, depth, ETA
        and error-rate rows, routing tallies, the recent-decision ring
        (entries carry trace ids) and the routing and failover journal;
        ``enabled: false`` without a pool."""
        pool = getattr(cp, "cluster", None)
        if pool is None:
            return web.json_response({"enabled": False})
        return web.json_response(pool.scoreboard_snapshot())

    async def costs_handler(request: web.Request) -> web.Response:
        """Cost observatory: per-executable analytic costs and compile
        counts (the capture sentinel's data), the ragged kernel's per-path
        engagement (under the reference's ``pallas`` key), device peaks and
        per-device HBM stats. Device queries wait for a ready engine."""
        engine = getattr(cp.planner, "engine", None)
        if engine is None or getattr(engine, "costs", None) is None:
            return web.json_response({
                "engine": None,
                "device": None,
                "reason": "no inference engine attached "
                "(heuristic/mock planner serves this control plane)",
            })
        if engine.state != "ready":
            return web.json_response({
                "engine": engine.costs.snapshot(materialize=False),
                "engine_state": engine.state,
                "pallas": engine.kernel_paths(),
                "device": None,
                "reason": "engine not ready; device stats deferred",
            })

        def _read():
            update_hbm_gauges(cp.metrics)
            return engine.costs.snapshot(), device_peaks(), hbm_stats()

        snap, peaks, hbm = await asyncio.to_thread(_read)
        return web.json_response({
            "engine": snap,
            "engine_state": engine.state,
            "pallas": engine.kernel_paths(),
            "device": {"peaks": peaks, "hbm": hbm},
        })

    # Device-side profiling: a torch.profiler trace of live serving,
    # started and stopped without a restart. profile["dir"]: None = idle,
    # _STARTING/_STOPPING = a transition in flight (a reservation no other
    # handler may touch), any other str = the active trace directory. One
    # thread runs every profiler call, so start and stop share its state.
    _STARTING = "<starting>"
    _STOPPING = "<stopping>"
    profile: dict[str, Any] = {"dir": None, "prof": None}
    profiler_thread = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mcpx-torch-profiler")

    def _start_trace() -> Any:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch_profile(activities=activities)
        prof.start()
        return prof

    def _stop_trace(prof: Any, trace_dir: str) -> None:
        prof.stop()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, f"mcpx_torch_{time.time_ns()}.trace.json"))

    async def profile_start(request: web.Request) -> web.Response:
        body = await _body(request) if request.can_read_body else {}
        if profile["dir"] is not None:
            return _json_error(409, f"profiling already active (dir={profile['dir']})")
        trace_dir = body.get("dir") or server_cfg.profile_dir
        if not isinstance(trace_dir, str) or not trace_dir:
            return _json_error(400, "'dir' must be a non-empty string")
        # Reserve before the await: a concurrent start must hit the 409
        # above, and a concurrent stop must see the sentinel and back off.
        profile["dir"] = _STARTING
        started = False
        try:
            loop = asyncio.get_running_loop()
            profile["prof"] = await loop.run_in_executor(profiler_thread, _start_trace)
            started = True
        except Exception as e:  # mcpx: ignore[broad-except] - profiler state errors -> client as 409
            return _json_error(409, f"could not start trace: {e}")
        finally:
            # Always resolves the reservation, cancellation included.
            profile["dir"] = trace_dir if started else None  # mcpx: ignore[async-shared-mutation] - resolving this handler's own reservation; racers were 409'd by it
        return web.json_response({"profiling": "started", "dir": trace_dir})

    async def profile_stop(request: web.Request) -> web.Response:
        if profile["dir"] is None:
            return _json_error(409, "profiling not active")
        if profile["dir"] in (_STARTING, _STOPPING):
            return _json_error(409, "profiler transition in progress; retry")
        trace_dir, profile["dir"] = profile["dir"], _STOPPING
        stopped = False
        try:
            # Off the event loop: writing the trace can take seconds.
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(profiler_thread, _stop_trace, profile["prof"], trace_dir)
            stopped = True
        except Exception as e:  # mcpx: ignore[broad-except] - error -> client as 500
            return _json_error(500, f"could not stop trace: {e}")
        finally:
            # On failure the profiler's state is unknown: keep it active
            # rather than wedge both endpoints behind 409s.
            profile["dir"] = None if stopped else trace_dir  # mcpx: ignore[async-shared-mutation] - resolving this handler's own reservation; racers were 409'd by it
            if stopped:
                profile["prof"] = None
        return web.json_response({"profiling": "stopped", "dir": trace_dir})

    app.router.add_post("/plan", plan)
    app.router.add_post("/execute", execute)
    app.router.add_post("/plan_and_execute", plan_and_execute)
    app.router.add_get("/services", list_services)
    app.router.add_post("/services", register_service)
    app.router.add_get("/services/{name}", get_service)
    app.router.add_delete("/services/{name}", delete_service)
    app.router.add_get("/metrics", metrics_handler)
    app.router.add_get("/costs", costs_handler)
    app.router.add_get("/traces", traces_handler)
    app.router.add_get("/traces/{trace_id}", trace_get)
    app.router.add_get("/explain/{trace_id}", explain_handler)
    app.router.add_get("/debug/anomalies", anomalies_handler)
    app.router.add_get("/debug/anomalies/{bundle_id}", anomaly_bundle_handler)
    app.router.add_get("/usage", usage_handler)
    app.router.add_get("/slo", slo_handler)
    app.router.add_get("/cluster", cluster_handler)
    app.router.add_post("/profile/start", profile_start)
    app.router.add_post("/profile/stop", profile_stop)
    app.router.add_get("/cache", cache_handler)
    app.router.add_get("/telemetry", telemetry_handler)
    app.router.add_get("/healthz", healthz)

    startup_task: dict[str, asyncio.Task] = {}

    async def _mirror_loop() -> None:
        # The telemetry mirror: export local stats, import the peers'.
        interval = cp.config.telemetry.mirror_interval_s
        while True:
            try:
                await cp.telemetry_mirror.sync()
            except asyncio.CancelledError:
                raise
            except Exception:  # losing the mirror must not stop serving
                log.exception("telemetry mirror sync failed; retrying next interval")
            await asyncio.sleep(interval)

    async def on_startup(app: web.Application) -> None:
        # Engine bring-up runs as a background task, not inline: on_startup
        # fires before the listening socket binds, so awaiting it here would
        # leave /healthz connection-refused the whole time. Requests that
        # arrive while warming wait inside engine.start(), which coalesces
        # concurrent callers.
        startup_task["t"] = asyncio.create_task(cp.startup())
        if cp.telemetry_mirror is not None:
            startup_task["mirror"] = asyncio.create_task(_mirror_loop())
        if cp.flight is not None:
            # The flight recorder's sampling loop; its bundle writes run off
            # the loop (asyncio.to_thread).
            startup_task["flight"] = asyncio.create_task(cp.flight.run())
        if getattr(cp, "cluster", None) is not None:
            # The pool's scoreboard refresh: per-replica health pulled off
            # the request path (routing scores read the cached snapshots).
            startup_task["cluster"] = asyncio.create_task(cp.cluster.run_scoreboard())

    async def _stop_loop(key: str, what: str) -> None:
        task = startup_task.pop(key, None)
        if task is None:
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass  # the cancel above landing, not a failure
        except Exception:
            log.exception("%s loop died with an error", what)

    async def on_cleanup(app: web.Application) -> None:
        await _stop_loop("cluster", "cluster scoreboard")
        await _stop_loop("flight", "flight recorder")
        if "mirror" in startup_task:
            await _stop_loop("mirror", "telemetry mirror")
            try:
                await cp.telemetry_mirror.aclose()
            except Exception:  # best effort at shutdown, and logged
                log.exception("telemetry mirror close failed")
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
        profiler_thread.shutdown(wait=False)
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
