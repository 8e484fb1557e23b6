"""Deterministic fault injection for crash-restart testing.

Counterpart of ``deepspeed_tpu/utils/chaos.py`` (no JAX; the port keeps its
own copy). A serving guarantee (streams resume byte-identically from the
journal) holds only if a kill at every dangerous instant is exercised. This
module names those instants as injection points and arms them with a
seeded, fully deterministic schedule.

Injection points (sites call ``chaos.point(NAME, ...)``):

* ``ckpt.pre_commit``  right before a staged checkpoint's commit rename;
* ``ckpt.mid_commit``  inside a re-save of an existing tag, after the old
  directory was moved aside and before the new one is renamed in;
* ``ckpt.mid_array_write`` after the tensor payload reached the staging
  directory, before ``meta.pkl`` and ``_COMPLETE``;
* ``ckpt.post_commit`` right after the commit rename, before the
  ``latest`` marker;
* ``train.mid_step``   inside an optimizer step, after the update reached
  the master and before the step's counters, lr schedule and interval
  checkpoint (resume must replay from the last committed checkpoint);
* ``train.mid_offload_stream`` once a bucket inside a streamed offload
  step, between the bucket's update and its writeback: staged buckets
  live, host buffers torn, the step uncommitted (resume rebuilds them from
  the last committed checkpoint, never from the buffers);
* ``serve.mid_step``   inside the serving scheduler step, after the device
  work and the emits, before the journal flush;
* ``serve.mid_window`` inside a multi-step window's host phase: every token
  of the window sits in the journal buffer, none is durable;
* ``journal.append``   right after a journal record batch reaches the OS
  (the torn-tail instant; pair it with the ``truncate`` action);
* ``fleet.replica_kill``  at the top of one replica's turn in the fleet
  router's step loop (``inference/fleet.py``): a ``raise`` there is that
  replica dying while the router and the other replicas survive (the
  router re-routes its live requests from its journal); ``exit`` still
  kills the whole process;
* ``fleet.mid_migration`` inside a live migration, after the state left
  the source's scheduler and before the target durably re-seeded it;
* ``fleet.mid_drain``     between two migrations of a drain: the draining
  replica dies half emptied, and the rest re-routes from its journal.

Actions: ``raise`` (``ChaosKilled``, a ``BaseException``, so recovery code
that catches ``Exception`` cannot survive it), ``exit`` (``os._exit(137)``),
``truncate`` and ``corrupt`` (chop or overwrite the last ``nbytes`` of
``ctx["path"]``, then raise).

Usage::

    from deepspeed_tpu_torch.utils import chaos
    chaos.install(chaos.ChaosSchedule([chaos.ChaosRule("serve.mid_step", hit=3)]))
    try:
        server.run()              # dies at the armed instant
    except chaos.ChaosKilled:
        pass
    finally:
        chaos.uninstall()

Disarmed by default: ``chaos.point`` is then one ``is None`` check.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

# the injection points the port's code calls (keep in sync with the call sites)
POINTS = (
    "ckpt.pre_commit",
    "ckpt.mid_commit",
    "ckpt.mid_array_write",
    "ckpt.post_commit",
    "train.mid_step",
    "train.mid_offload_stream",
    "serve.mid_step",
    "serve.mid_window",
    "journal.append",
    "fleet.replica_kill",
    "fleet.mid_migration",
    "fleet.mid_drain",
)

_ACTIONS = ("raise", "exit", "truncate", "corrupt")


class ChaosKilled(BaseException):
    """The simulated kill. Not an ``Exception``: code that catches
    ``Exception`` must not survive a kill, as nothing survives SIGKILL."""


@dataclass
class ChaosRule:
    """Fire ``action`` on the ``hit``-th arrival at ``point`` (1-based)."""

    point: str
    hit: int = 1
    action: str = "raise"
    nbytes: int = 16  # tail bytes for truncate / corrupt
    fired: bool = field(default=False, init=False)

    def __post_init__(self):
        if self.action not in _ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r} (have {_ACTIONS})")
        if self.hit < 1:
            raise ValueError(f"hit is 1-based, got {self.hit}")


class ChaosSchedule:
    """An armed set of rules plus per-point arrival counters: the n-th
    arrival at a point always sees the same verdict."""

    def __init__(self, rules: Sequence[ChaosRule]):
        self.rules = list(rules)
        self.counts: Dict[str, int] = {}
        self.fired_log: List[str] = []  # "<point>#<hit>:<action>" per firing

    def fire(self, point: str, **ctx) -> None:
        n = self.counts.get(point, 0) + 1
        self.counts[point] = n
        for rule in self.rules:
            if rule.fired or rule.point != point or rule.hit != n:
                continue
            rule.fired = True
            self.fired_log.append(f"{point}#{n}:{rule.action}")
            self._act(rule, ctx)

    def _act(self, rule: ChaosRule, ctx: Dict) -> None:
        # pre-death hooks run before the action, so a postmortem exists even
        # for os._exit; a failing hook never saves the process
        for hook in list(_KILL_HOOKS):
            try:
                hook(rule.point, rule.action)
            except Exception:
                pass
        if rule.action == "exit":
            os._exit(137)
        if rule.action in ("truncate", "corrupt"):
            # file surgery applies only to a file-backed point; elsewhere the
            # action is the plain kill, never a swallowable OSError
            path = ctx.get("path")
            if path and os.path.isfile(path):
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    if rule.action == "truncate":
                        f.truncate(max(0, size - rule.nbytes))
                    else:
                        n = min(rule.nbytes, size)
                        f.seek(size - n)
                        # deterministic garbage: position-keyed, not random
                        f.write(bytes((0xA5 ^ (i & 0xFF)) for i in range(n)))
        raise ChaosKilled(f"chaos: killed at {rule.point} (hit {rule.hit})")


_SCHEDULE: Optional[ChaosSchedule] = None

# pre-death hooks: callables (point, action) -> None run right before a
# rule's action (before the ChaosKilled raise and before os._exit)
_KILL_HOOKS: List = []


def add_kill_hook(fn) -> None:
    if fn not in _KILL_HOOKS:
        _KILL_HOOKS.append(fn)


def remove_kill_hook(fn) -> None:
    if fn in _KILL_HOOKS:
        _KILL_HOOKS.remove(fn)


def install(schedule: ChaosSchedule) -> ChaosSchedule:
    """Arm a schedule (replacing any armed one) and return it."""
    global _SCHEDULE
    _SCHEDULE = schedule
    return schedule


def uninstall() -> None:
    global _SCHEDULE
    _SCHEDULE = None


def active() -> Optional[ChaosSchedule]:
    return _SCHEDULE


def point(name: str, **ctx) -> None:
    """An injection site. Free when disarmed (one None check)."""
    if _SCHEDULE is not None:
        _SCHEDULE.fire(name, **ctx)


def seeded_schedule(
    seed: int,
    points: Sequence[str] = POINTS,
    n_faults: int = 1,
    max_hit: int = 3,
    actions: Sequence[str] = ("raise",),
) -> ChaosSchedule:
    """A reproducible schedule: ``seed`` decides which points fire, on which
    arrival, with which action (numpy's ``RandomState``, as in JAX's copy)."""
    import numpy as np

    rs = np.random.RandomState(seed)
    rules = [
        ChaosRule(
            point=points[int(rs.randint(len(points)))],
            hit=int(rs.randint(1, max_hit + 1)),
            action=actions[int(rs.randint(len(actions)))],
        )
        for _ in range(n_faults)
    ]
    return ChaosSchedule(rules)
