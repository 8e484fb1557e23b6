"""The part of ``deepspeed_tpu/profiling/tracer.py`` the scheduler needs.

``NULL_TRACER`` (a disabled tracer whose spans are no-ops),
``MetricsRegistry`` with counters and histograms, and
``percentile_summary``. The span ring buffer, Chrome-trace export and
flight recorder are not ported yet.
"""

from __future__ import annotations

import bisect
from typing import Any, Dict, Optional, Sequence, Tuple


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":  # noqa: ARG002
        return self


_NULL_SPAN = _NullSpan()


class NullTracer:
    """A tracer that records nothing: every call is a no-op."""

    enabled = False

    def span(self, name: str, **attrs):  # noqa: ARG002
        return _NULL_SPAN

    def begin_async(self, cat, aid, name, **attrs) -> None:  # noqa: ARG002
        pass

    instant_async = begin_async
    end_async = begin_async

    def event(self, name: str, **attrs) -> None:  # noqa: ARG002
        pass


NULL_TRACER = NullTracer()


def percentile_summary(values) -> Dict[str, float]:
    """``{count, mean, p50, p99}`` of a host-side sample (``{'count': 0}``
    when empty), linear interpolation as numpy's default percentile."""
    vals = sorted(float(v) for v in values)
    n = len(vals)
    if n == 0:
        return {"count": 0}

    def pct(q: float) -> float:
        if n == 1:
            return vals[0]
        pos = q / 100.0 * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)

    return {"count": n, "mean": sum(vals) / n, "p50": pct(50.0), "p99": pct(99.0)}


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> float:
        return self.value


_DEFAULT_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0,
    100.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
)


class Histogram:
    """Fixed-bucket histogram; ``percentile`` interpolates inside the
    landing bucket and clamps to the observed range."""

    def __init__(self, name: str, buckets: Optional[Sequence[float]] = None):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(sorted(buckets or _DEFAULT_BUCKETS))
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self.count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self._counts[bisect.bisect_left(self.bounds, v)] += 1
        self._sum += v
        self.count += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def percentile(self, p: float) -> float:
        if self.count == 0:
            return 0.0
        target = max(1.0, p / 100.0 * self.count)
        cum = 0
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if cum + c >= target:
                lo = self.bounds[i - 1] if i > 0 else self._min
                hi = self.bounds[i] if i < len(self.bounds) else self._max
                val = lo + (hi - lo) * (target - cum) / c
                return min(max(val, self._min), self._max)
            cum += c
        return self._max

    def snapshot(self) -> Dict[str, Any]:
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": self._sum,
            "mean": self._sum / self.count,
            "min": self._min,
            "max": self._max,
            "p50": self.percentile(50),
            "p99": self.percentile(99),
        }


class MetricsRegistry:
    """Named metric store: re-requesting a name returns the same instance;
    requesting it as another kind raises."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, kind, *args):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name, *args)
        elif not isinstance(m, kind):
            raise TypeError(
                f"metric {name!r} already registered as {type(m).__name__}, "
                f"requested {kind.__name__}"
            )
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def histogram(self, name: str, buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(name, Histogram, buckets)

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"counters": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            key = "counters" if isinstance(m, Counter) else "histograms"
            out[key][name] = m.snapshot()
        return out
