"""The port's plan-quality proxies (``mcpx_torch.planner.quality``) against
the reference's: the reference's ordering case, and seeded random plans
over a synthetic registry, as ``Plan`` objects and as wire dicts, scored
equal to the reference's numbers exactly."""

import random

import pytest

from mcpx.core.dag import Plan as JPlan
from mcpx.planner import quality as jq
from mcpx.utils.synth import synth_registry as jsynth
from mcpx_torch.core.dag import Plan
from mcpx_torch.planner import quality as tq
from mcpx_torch.utils.synth import intent_for, synth_registry

RECORDS = {
    "auth-fetch-0001": {"tags": ["auth", "fetch"], "input_schema": {"query": "str"},
                        "output_schema": {"user_id": "str"}},
    "billing-score-0002": {"tags": ["billing", "score"], "input_schema": {"user_id": "str"},
                           "output_schema": {"score": "str"}},
    "geo-sync-0003": {"tags": ["geo", "sync"], "input_schema": {"address": "str"},
                      "output_schema": {"status": "str"}},
}
GOOD = {
    "nodes": [{"name": "auth-fetch-0001", "service": "auth-fetch-0001"},
              {"name": "billing-score-0002", "service": "billing-score-0002"}],
    "edges": [{"from": "auth-fetch-0001", "to": "billing-score-0002"}],
}
BAD = {"nodes": [{"name": "geo-sync-0003", "service": "geo-sync-0003"}], "edges": []}


def test_quality_metric_orders_plans():
    """The reference's ``test_quality_metric_orders_plans``, on the port."""
    intent = "please auth then fetch then billing then score"
    q_good = tq.plan_quality(GOOD, intent, RECORDS)
    q_bad = tq.plan_quality(BAD, intent, RECORDS)
    assert q_good["coverage"] == 1.0 and q_good["relevance"] == 1.0
    assert q_good["coherence"] == 1.0  # user_id flows auth->billing
    assert q_bad["coverage"] == 0.0 and q_bad["relevance"] == 0.0
    assert q_good["score"] > q_bad["score"]
    assert tq.node_f1(GOOD, GOOD) == 1.0 and tq.node_f1(GOOD, BAD) == 0.0
    m = tq.mean_quality([q_good, q_bad])
    assert m["n"] == 2 and 0 < m["score"] < 1
    for fn, args in ((tq.plan_quality, (GOOD, intent, RECORDS)), (tq.plan_quality, (BAD, intent, RECORDS)),
                     (tq.node_f1, (GOOD, BAD)), (tq.mean_quality, ([q_good, q_bad],)), (tq.mean_quality, ([],))):
        assert fn(*args) == getattr(jq, fn.__name__)(*args)


def _random_plan(rng: random.Random, names: list) -> dict:
    picks = rng.sample(names, rng.randint(1, 4)) + (["ghost-9999"] if rng.random() < 0.2 else [])
    edges = [{"from": a, "to": b} for a, b in zip(picks, picks[1:]) if rng.random() < 0.7]
    return {"nodes": [{"name": n, "service": n} for n in picks], "edges": edges}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_random_plans_score_as_the_reference(seed):
    """Random plans (unknown services, edge-less plans and partial chains
    included) over a 60-service registry: every per-plan score, the
    aggregate, and node F1 against the next plan equal the reference's, for
    ``Plan`` objects, wire dicts and ``ServiceRecord`` or dict records."""
    records, jrecords = synth_registry(60, seed=seed), jsynth(60, seed=seed)
    by_name = {r.name: r for r in records}
    jby_name = {r.name: r for r in jrecords}
    as_dicts = {r.name: r.to_dict() for r in records}
    rng = random.Random(seed)
    names = [r.name for r in records]
    wires = [_random_plan(rng, names) for _ in range(24)]
    intents = [intent_for(records, rng, n_services=rng.randint(1, 4)) for _ in wires]
    rows, jrows = [], []
    for i, (wire, intent) in enumerate(zip(wires, intents)):
        ref = jq.plan_quality(JPlan.from_wire(wire), intent, jby_name)
        assert tq.plan_quality(Plan.from_wire(wire), intent, by_name) == ref
        assert tq.plan_quality(wire, intent, as_dicts) == ref
        rows.append(tq.plan_quality(wire, intent, by_name))
        jrows.append(ref)
        other = wires[(i + 1) % len(wires)]
        assert tq.node_f1(Plan.from_wire(wire), other) == jq.node_f1(JPlan.from_wire(wire), other)
    assert tq.mean_quality(rows) == jq.mean_quality(jrows)
    assert tq.mean_quality([{k: v for k, v in r.items() if k != "n_edges"} for r in rows]) == \
        jq.mean_quality([{k: v for k, v in r.items() if k != "n_edges"} for r in jrows])
