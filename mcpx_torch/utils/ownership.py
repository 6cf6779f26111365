"""Runtime-inert thread-ownership annotations.

Copy of ``mcpx/utils/ownership.py``: the marks are kept so a later lint pass
over the port can read them as mcpxlint reads the reference's.

The engine's single-writer invariants (the worker thread owns the slab,
the radix prefix tree and the page allocator — SURVEY.md §5) used to live
only in comments. These decorators make them machine-checkable: the
``thread-ownership`` pass (mcpx/analysis/rules/ownership_rules.py) proves
every mutation is reachable only from the owning thread's entry points.

At runtime both decorators only tag the callable and return it unchanged —
zero overhead on the hot path.

    @owned_by("engine-worker")      # this callable mutates engine-worker
    def insert(self, ...): ...      # state: callers must be worker-only

    def _worker(self):              # mcpx: thread-entry[engine-worker]
        ...                         # (comment form: marks a thread target)

Field-level ownership is declared with a trailing comment on the
assignment (``self._x = ...  # mcpx: owner[<thread>]``, optionally
``owner[<thread>, atomic]`` for GIL-atomic cross-thread reads — angle
brackets here keep the doc example from parsing as a declaration); see
docs/static-analysis.md for the full annotation reference.
"""

from __future__ import annotations

from typing import Callable, TypeVar

T = TypeVar("T")


def owned_by(owner: str) -> Callable[[T], T]:
    """Declare a function, method or class as part of ``owner``'s
    single-writer domain: mcpxlint flags any call path into it that does
    not originate at one of ``owner``'s thread entry points."""

    def deco(obj: T) -> T:
        try:
            obj.__mcpx_owner__ = owner  # type: ignore[attr-defined]
        except (AttributeError, TypeError):  # slotted class etc. — tag is advisory
            pass
        return obj

    return deco


def thread_entry(owner: str) -> Callable[[T], T]:
    """Declare a function as a thread entry point of ``owner``'s domain
    (the ``target=`` of that thread): ownership call-path checks terminate
    here."""

    def deco(obj: T) -> T:
        try:
            obj.__mcpx_thread_entry__ = owner  # type: ignore[attr-defined]
        except (AttributeError, TypeError):
            pass
        return obj

    return deco
