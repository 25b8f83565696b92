"""Concurrency annotations read by the ``locks`` pass.

Two ways to declare that state is thread-shared:

1. A class-level ``SHARED_UNDER`` map from attribute name to the name
   of the lock attribute that guards it::

       class BatchEngine:
           SHARED_UNDER = {"_outstanding": "_exec_lock"}

   Every mutation of ``self._outstanding`` (assignment, ``+=``, item
   assignment, or a method call on it — ``.pop()``, ``.clear()``, …)
   must then sit lexically inside ``with self._exec_lock:``.

2. ``@locked_by("_exec_lock")`` on a method whose *callers* hold the
   lock — the method body is treated as lock-held (the supervisor's
   ``_set_state`` pattern).  The decorator is a runtime no-op; it only
   exists for the analyzer (and the human reader) to see.

The analyzer is lexical: it does not track lock handoffs through
aliases or across threads.  Declare the simple truth and keep the
locking simple enough for a lexical checker — that is the point.
"""

from __future__ import annotations

from typing import Callable, TypeVar

F = TypeVar("F", bound=Callable)


def locked_by(lock_attr: str) -> Callable[[F], F]:
    """Mark a method as "callers hold ``self.<lock_attr>``".

    Runtime no-op; consumed by ``evam_tpu_torch.analysis.locks``.
    """

    def mark(fn: F) -> F:
        fn.__locked_by__ = lock_attr
        return fn

    return mark
