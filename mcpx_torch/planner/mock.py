"""Canned planner for tests and integration harnesses: the PyTorch port's copy
of ``mcpx/planner/mock.py`` (``planner.kind="mock"``)."""

from __future__ import annotations

import copy
from typing import Awaitable, Callable, Optional, Union

from mcpx_torch.core.dag import Plan
from mcpx_torch.core.errors import PlannerError
from mcpx_torch.planner.base import PlanContext

PlanFactory = Callable[[str, PlanContext], Union[Plan, Awaitable[Plan]]]


class MockPlanner:
    """Returns canned plans: a fixed plan, an intent→plan mapping, or a
    factory callable. Raises ``PlannerError`` for unknown intents."""

    def __init__(
        self,
        plan: Optional[Plan] = None,
        by_intent: Optional[dict[str, Plan]] = None,
        factory: Optional[PlanFactory] = None,
    ) -> None:
        self._plan = plan
        self._by_intent = by_intent or {}
        self._factory = factory

    async def plan(self, intent: str, context: PlanContext) -> Plan:
        if self._factory is not None:
            out = self._factory(intent, context)
            if hasattr(out, "__await__"):
                out = await out  # type: ignore[assignment]
            plan = out
        elif intent in self._by_intent:
            plan = self._by_intent[intent]
        elif self._plan is not None:
            plan = self._plan
        else:
            raise PlannerError(f"mock planner has no plan for intent {intent!r}")
        # Deep-copy: canned plans are templates; callers (and the plan cache)
        # must never alias one mutable Plan across intents.
        plan = copy.deepcopy(plan)
        plan.validate()
        plan.intent = intent
        plan.origin = plan.origin or "mock"
        return plan
