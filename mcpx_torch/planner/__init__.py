from mcpx_torch.planner.base import Planner, PlanContext
from mcpx_torch.planner.mock import MockPlanner
from mcpx_torch.planner.heuristic import HeuristicPlanner

__all__ = ["Planner", "PlanContext", "MockPlanner", "HeuristicPlanner"]
