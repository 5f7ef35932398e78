"""Structured timing + profiling hooks.

The reference's tracing story is ad-hoc ``time.time()`` brackets with ANSI
prints and a ``self.compiled`` flag to separate first-call compile time from
steady state (stiffnessMtrx.py:116, 736-744; SURVEY.md §5).  This module
gives the same signal as structured records plus ``jax.profiler`` trace
integration for device profiling.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional

logger = logging.getLogger("femcy_tpu.timing")


@dataclasses.dataclass
class TimingRecord:
    name: str
    seconds: float
    first_call: bool  # True for the compile-included first call


class Timer:
    """Collects named timing records; first call per name is flagged as the
    compile-included one (XLA has the same first-call compile cost the
    reference struggles with, README.md:21)."""

    def __init__(self, verbose: bool = False):
        self.records: List[TimingRecord] = []
        self._seen: set = set()
        self.verbose = verbose

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            first = name not in self._seen
            self._seen.add(name)
            self.records.append(TimingRecord(name, dt, first))
            if self.verbose:
                tag = " (incl. compile)" if first else ""
                logger.info("%s: %.4fs%s", name, dt, tag)

    def summary(self) -> Dict[str, Dict[str, float]]:
        """name -> {first (compile-included), steady_mean, steady_min, count}."""
        by_name: Dict[str, List[TimingRecord]] = defaultdict(list)
        for r in self.records:
            by_name[r.name].append(r)
        out = {}
        for name, recs in by_name.items():
            steady = [r.seconds for r in recs if not r.first_call]
            first = next((r.seconds for r in recs if r.first_call), None)
            out[name] = {
                "first": first,
                "steady_mean": sum(steady) / len(steady) if steady else None,
                "steady_min": min(steady) if steady else None,
                "count": len(recs),
            }
        return out


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a block in a ``jax.profiler`` trace when a log dir is given.

    View with TensorBoard / xprof; no-op when log_dir is None.
    """
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
