"""CLI: ``python -m mcpx_torch.cli`` — serve the port's control plane, read a
running server's traces, bundles, explanations, usage and SLO budgets,
validate plans, generate registries, train and evaluate the planner model,
and report on the bench series.

The PyTorch port's copy of ``mcpx/cli/main.py``, with the reference's
arguments and output. ``serve``, ``train-planner`` and ``eval-planner`` take
``--device`` (default: the GPU; they raise without one) where the reference
takes ``--platform``; ``serve`` needs aiohttp. ``train-planner`` writes
``planner_test_bpe.npz`` in the working directory by default, never into the
reference package's committed checkpoint. ``lint`` is not ported yet: it is
refused by name, naming the ROADMAP item that ports it, and exits 2.
"""

from __future__ import annotations

import argparse
import json
import sys

from mcpx_torch.core.config import MCPXConfig

# Commands of the reference CLI that the port refuses, and the ROADMAP
# (Queue A) item that ports each.
REFUSED = {
    "lint": "item 7, static analysis",
}


def _load_config(args: argparse.Namespace) -> MCPXConfig:
    if args.config:
        cfg = MCPXConfig.from_file(args.config)
    else:
        cfg = MCPXConfig.from_env()
    if args.registry_file:
        cfg.registry.backend = "file"
        cfg.registry.file_path = args.registry_file
    if args.planner:
        cfg.planner.kind = args.planner
    return cfg


def cmd_serve(args: argparse.Namespace) -> int:
    import os

    from mcpx_torch.server.app import build_app, web
    from mcpx_torch.server.factory import build_control_plane
    from mcpx_torch.telemetry.tracing import configure_logging

    # Every log line carries the active request's trace_id/span_id;
    # MCPX_LOG_JSON=1 or --log-json switches to one JSON object per line.
    configure_logging(json_logs=bool(args.log_json or os.environ.get("MCPX_LOG_JSON") == "1"))
    cfg = _load_config(args)
    if args.port:
        cfg.server.port = args.port
    if args.chaos:
        # Serve through the seeded fault injector the profile describes.
        cfg.resilience.chaos_profile = args.chaos
    cp = build_control_plane(cfg, device=args.device)
    web.run_app(build_app(cp), host=cfg.server.host, port=cfg.server.port)
    return 0


def _http_json(url: str, timeout_s: float = 10.0):
    """GET ``url`` -> parsed JSON. A synchronous CLI has no event loop to
    block, so urllib serves one call without an aiohttp session."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        try:
            detail = json.loads(e.read().decode()).get("error", "")
        except (OSError, ValueError, AttributeError):  # the body is best-effort detail
            detail = ""
        raise RuntimeError(f"{url}: HTTP {e.code} {detail}".strip()) from e
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(f"{url}: {e}") from e


def _newest_trace_id(base: str) -> str:
    traces = _http_json(f"{base}/traces").get("traces", [])
    return traces[0]["trace_id"] if traces else ""


def cmd_trace(args: argparse.Namespace) -> int:
    """Inspect or export the server's retained traces. ``list`` prints the
    ring's summaries; ``dump`` writes one trace as Chrome trace-event JSON,
    which loads in Perfetto (ui.perfetto.dev) or chrome://tracing."""
    base = args.url.rstrip("/")
    try:
        if args.action == "list":
            print(json.dumps(_http_json(f"{base}/traces"), indent=2))
            return 0
        trace_id = args.id or _newest_trace_id(base)
        if not trace_id:
            print(json.dumps({"error": "no traces retained on the server"}))
            return 1
        chrome = _http_json(f"{base}/traces/{trace_id}?format=chrome")
        out_path = args.out or f"trace_{trace_id}.json"
        with open(out_path, "w") as f:
            json.dump(chrome, f)
        print(json.dumps({
            "trace_id": trace_id, "wrote": out_path, "events": len(chrome.get("traceEvents", [])),
            "open_with": "https://ui.perfetto.dev (Open trace file)",
        }))
        return 0
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1


def cmd_debug(args: argparse.Namespace) -> int:
    """Flight-recorder tooling: ``list`` prints the detectors' state;
    ``bundle`` fetches one diagnostic bundle (``--id``, or the newest
    captured), validates its schema and writes it to a local file."""
    from mcpx_torch.telemetry.flight import _bundle_trace_ids, validate_bundle

    base = args.url.rstrip("/")
    try:
        status = _http_json(f"{base}/debug/anomalies")
        if args.action == "list":
            print(json.dumps(status, indent=2))
            return 0
        if not status.get("enabled"):
            print(json.dumps({"error": "flight recorder disabled on the server"}))
            return 1
        bundle_id = args.id
        if not bundle_id:
            bundles = status.get("bundles", [])
            if not bundles:
                print(json.dumps({"error": "no bundles captured on the server"}))
                return 1
            bundle_id = bundles[-1]["bundle_id"]
        bundle = _http_json(f"{base}/debug/anomalies/{bundle_id}")
        problems = validate_bundle(bundle)
        out_path = args.out or f"bundle_{bundle_id}.json"
        with open(out_path, "w") as f:
            json.dump(bundle, f, indent=2)
        print(json.dumps({
            "bundle_id": bundle_id, "wrote": out_path, "valid": not problems,
            **({"problems": problems} if problems else {}),
            "trigger": bundle.get("trigger"), "window_snapshots": len(bundle.get("window") or []),
            "trace_ids": _bundle_trace_ids(bundle)[:8],
        }))
        return 0 if not problems else 1
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1


def cmd_explain(args: argparse.Namespace) -> int:
    """Decision-provenance explanation of one trace (``GET
    /explain/{trace_id}``): validates the schema, prints the narrative and
    then the structured JSON. Without a trace id it explains the newest
    retained trace, so ``explain`` right after a failed request explains
    that request."""
    from mcpx_torch.telemetry.provenance import validate_explanation

    base = args.url.rstrip("/")
    try:
        trace_id = args.trace_id or _newest_trace_id(base)
        if not trace_id:
            print(json.dumps({"error": "no traces retained on the server"}))
            return 1
        out = _http_json(f"{base}/explain/{trace_id}")
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    problems = validate_explanation(out)
    for line in out.get("narrative", []):
        print(line)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    if problems:
        print(json.dumps({"error": "invalid explanation", "problems": problems}))
        return 1
    return 0


def cmd_usage(args: argparse.Namespace) -> int:
    """The per-tenant usage ledger of a running server (``GET /usage``):
    itemized cost aggregates per tenant and the recent bills."""
    base = args.url.rstrip("/")
    try:
        out = _http_json(f"{base}/usage")
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if not out.get("enabled"):
        print(json.dumps({"error": "cost ledger disabled on the server"}))
        return 1
    if args.tenant:
        acct = out.get("tenants", {}).get(args.tenant)
        out = {
            "enabled": True, "tenant": args.tenant, "totals": acct,
            "recent": [b for b in out.get("recent", []) if b.get("tenant") == args.tenant],
        }
        if acct is None:
            out["error"] = f"no usage recorded for tenant '{args.tenant}'"
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 0


def cmd_slo(args: argparse.Namespace) -> int:
    """SLO error-budget state of a running server (``GET /slo``): burn rates
    and budget left per objective, global and per tenant. Exits 3 when a
    global objective is breaching, so scripts can gate on budget health."""
    base = args.url.rstrip("/")
    try:
        out = _http_json(f"{base}/slo")
    except RuntimeError as e:
        print(json.dumps({"error": str(e)}))
        return 1
    if not out.get("enabled"):
        print(json.dumps({"error": "SLO engine disabled on the server"}))
        return 1
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return 3 if out.get("global", {}).get("breaching") else 0


def cmd_validate(args: argparse.Namespace) -> int:
    """Validate a plan JSON file against the DAG schema."""
    from mcpx_torch.core.dag import Plan, PlanValidationError

    if args.file == "-":
        text = sys.stdin.read()
    else:
        try:
            with open(args.file) as f:
                text = f.read()
        except OSError as e:
            print(json.dumps({"valid": False, "problems": [f"cannot read {args.file}: {e}"]}))
            return 1
    try:
        plan = Plan.from_json(text)
    except PlanValidationError as e:
        print(json.dumps({"valid": False, "problems": e.problems}, indent=2))
        return 1
    print(json.dumps({"valid": True, "generations": plan.topological_generations()}, indent=2))
    return 0


def cmd_gen_registry(args: argparse.Namespace) -> int:
    """Write a synthetic N-service registry file (benchmarks, demos)."""
    from mcpx_torch.utils.synth import synth_registry

    records = synth_registry(args.n, seed=args.seed)
    with open(args.out, "w") as f:
        json.dump([r.to_dict() for r in records], f, indent=2)
    print(f"wrote {len(records)} services to {args.out}")
    return 0


def cmd_train_planner(args: argparse.Namespace) -> int:
    """Train the in-tree planner model on the synthetic workload corpus and
    write a single-file .npz checkpoint (models/train.py)."""
    import time

    from mcpx_torch.device import resolve_device
    from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
    from mcpx_torch.models.gemma.config import GemmaConfig
    from mcpx_torch.models.tokenizer import make_tokenizer
    from mcpx_torch.models.train import TrainConfig, load_npz, save_npz, train

    device = resolve_device(args.device)
    tok = make_tokenizer(args.vocab)
    ccfg = CorpusConfig(
        n_examples=args.examples,
        registry_size=args.registry,
        seed=args.seed,
        intent_seed=args.intent_seed,
    )
    t0 = time.time()
    corpus = build_corpus_sync(tok, ccfg, device=device)
    print(
        f"corpus: {corpus.tokens.shape[0]} rows (dropped {corpus.n_dropped}, "
        f"filtered {corpus.n_filtered}, teacher coverage "
        f"{corpus.teacher_coverage:.3f}) in {time.time() - t0:.1f}s"
    )
    cfg = GemmaConfig.named(args.size, vocab_size=tok.vocab_size)
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch, lr=args.lr, seed=args.seed)
    # Warm start (fine-tune): e.g. extend intent coverage over the same
    # registry with --intent-seed, at a lower --lr.
    init = load_npz(args.init, device, "float32") if args.init else None
    t0 = time.time()
    params, report = train(cfg, corpus, tcfg, device=device, init=init, log_fn=lambda m: print(m, flush=True))
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s: {report}")
    save_npz(args.out, params)
    print(f"wrote {args.out}")
    return 0


def cmd_eval_planner(args: argparse.Namespace) -> int:
    """Serve a planner checkpoint through the real stack (engine +
    grammar-constrained decode + retrieval shortlist) and print its
    plan-quality metrics as one JSON line (planner/evaluate.py)."""
    import asyncio

    from mcpx_torch.planner.evaluate import evaluate_planner

    out = asyncio.run(
        evaluate_planner(
            checkpoint=args.checkpoint,
            size=args.size,
            vocab=args.vocab,
            registry_size=args.registry,
            registry_seed=args.registry_seed,
            n_intents=args.intents,
            seed=args.seed,
            device=args.device,
            constrain_names=args.constrain_names,
            quantize=args.quantize,
        )
    )
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in out.items()}))
    return 0


def cmd_bench_report(args: argparse.Namespace) -> int:
    """Regression report over the BENCH_r*.json series (cli/bench_report.py):
    scenario-keyed per-metric deltas with noise bands and a verdict."""
    from mcpx_torch.cli.bench_report import run_report

    return run_report(args.paths, fmt=args.format, fail_on_regression=args.fail_on_regression)


def _url_option(p: argparse.ArgumentParser) -> None:
    p.add_argument("--url", default="http://127.0.0.1:8000", help="server base URL (default: %(default)s)")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="mcpx_torch")
    parser.add_argument("--config", help="JSON config file")
    parser.add_argument("--registry-file", help="service registry JSON file")
    parser.add_argument("--planner", choices=["llm", "heuristic", "mock"])
    sub = parser.add_subparsers(dest="command", required=True)

    p_serve = sub.add_parser("serve", help="run the control-plane server")
    p_serve.add_argument("--port", type=int, default=0)
    p_serve.add_argument("--device", default=None, help="torch device (default: cuda)")
    p_serve.add_argument(
        "--log-json", action="store_true",
        help="one JSON object per log line (trace_id/span_id fields included)",
    )
    p_serve.add_argument(
        "--chaos", default="", metavar="PROFILE_JSON",
        help="serve through a seeded fault-injecting transport described by this chaos profile file",
    )
    p_serve.set_defaults(func=cmd_serve)

    p_trace = sub.add_parser("trace", help="inspect/export request traces from a running server")
    p_trace.add_argument("action", choices=["list", "dump"])
    _url_option(p_trace)
    p_trace.add_argument("--id", default="", help="trace id to dump (default: the newest retained trace)")
    p_trace.add_argument("--out", default="", help="output path for dump (default: trace_<id>.json)")
    p_trace.set_defaults(func=cmd_trace)

    p_debug = sub.add_parser(
        "debug", help="flight-recorder tooling: list detector state, fetch anomaly bundles"
    )
    p_debug.add_argument("action", choices=["list", "bundle"])
    _url_option(p_debug)
    p_debug.add_argument("--id", default="", help="bundle id to fetch (default: the newest captured bundle)")
    p_debug.add_argument("--out", default="", help="output path for bundle (default: bundle_<id>.json)")
    p_debug.set_defaults(func=cmd_debug)

    p_explain = sub.add_parser(
        "explain", help="decision-provenance narrative for one trace from a running server"
    )
    p_explain.add_argument(
        "trace_id", nargs="?", default="", help="trace id to explain (default: the newest retained trace)"
    )
    _url_option(p_explain)
    p_explain.add_argument("--out", default="", help="also write the explanation JSON to this path")
    p_explain.set_defaults(func=cmd_explain)

    p_usage = sub.add_parser("usage", help="per-tenant usage ledger from a running server")
    _url_option(p_usage)
    p_usage.add_argument("--tenant", default="", help="show one tenant's totals + recent bills only")
    p_usage.add_argument("--out", default="", help="also write the report to this path")
    p_usage.set_defaults(func=cmd_usage)

    p_slo = sub.add_parser("slo", help="SLO error-budget state from a running server")
    _url_option(p_slo)
    p_slo.add_argument("--out", default="", help="also write the report to this path")
    p_slo.set_defaults(func=cmd_slo)

    p_val = sub.add_parser("validate", help="validate a plan JSON file")
    p_val.add_argument("file", help="path or - for stdin")
    p_val.set_defaults(func=cmd_validate)

    p_gen = sub.add_parser("gen-registry", help="generate a synthetic registry")
    p_gen.add_argument("n", type=int)
    p_gen.add_argument("--out", default="registry.json")
    p_gen.add_argument("--seed", type=int, default=0)
    p_gen.set_defaults(func=cmd_gen_registry)

    p_train = sub.add_parser("train-planner", help="train the in-tree planner model (synthetic corpus)")
    p_train.add_argument("--out", default="planner_test_bpe.npz",
                         help="checkpoint to write (default: %(default)s in the working directory)")
    p_train.add_argument("--size", default="test")
    p_train.add_argument("--vocab", default="bpe")
    p_train.add_argument("--examples", type=int, default=4096)
    p_train.add_argument("--registry", type=int, default=1000)
    p_train.add_argument("--steps", type=int, default=2500)
    p_train.add_argument("--batch", type=int, default=24)
    p_train.add_argument("--lr", type=float, default=3e-3)
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--intent-seed", type=int, default=None, help="fresh intent draws over the same registry")
    p_train.add_argument("--init", default="", help="warm-start from an existing .npz checkpoint")
    p_train.add_argument("--device", default=None, help="torch device (default: cuda)")
    p_train.set_defaults(func=cmd_train_planner)

    p_eval = sub.add_parser("eval-planner", help="score a planner checkpoint's plan quality")
    p_eval.add_argument("--checkpoint", default="mcpx/models/checkpoints/planner_test_bpe.npz")
    p_eval.add_argument("--size", default="test")
    p_eval.add_argument("--vocab", default="bpe")
    p_eval.add_argument("--registry", type=int, default=1000)
    p_eval.add_argument("--registry-seed", type=int, default=0)
    p_eval.add_argument("--intents", type=int, default=48)
    p_eval.add_argument("--seed", type=int, default=1234)
    p_eval.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="serve the checkpoint weight-only quantized (models/gemma/quant.py)")
    p_eval.add_argument("--constrain-names", choices=["registry", "shortlist"], default="registry",
                        help="grammar tier: registry-wide name trie (serving default) or shortlist-only "
                        "(tightest constraint)")
    p_eval.add_argument("--device", default=None, help="torch device (default: cuda)")
    p_eval.set_defaults(func=cmd_eval_planner)

    p_bench = sub.add_parser("bench", help="bench artifact tooling (regression tracking)")
    bench_sub = p_bench.add_subparsers(dest="bench_command", required=True)
    p_breport = bench_sub.add_parser("report", help="per-metric regression verdict over the BENCH_r*.json series")
    p_breport.add_argument("paths", nargs="*",
                           help="bench artifacts in series order (default: ./BENCH_r*.json sorted)")
    p_breport.add_argument("--format", choices=["text", "json"], default="text", help="report format")
    p_breport.add_argument("--fail-on-regression", action="store_true",
                           help="exit 1 when any tracked metric regressed beyond its noise band")
    p_breport.set_defaults(func=cmd_bench_report)

    # A refused command parses whatever follows it, so its refusal names the
    # command whatever arguments it was given.
    sub.add_parser("lint", help=f"not served by the PyTorch port yet (ROADMAP {REFUSED['lint']})")

    args, extra = parser.parse_known_args(argv)
    command = args.command
    if command in REFUSED:
        print(
            f"mcpx_torch {command}: not served by the PyTorch port yet (ROADMAP Queue A {REFUSED[command]})",
            file=sys.stderr,
        )
        return 2
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.func(args)
