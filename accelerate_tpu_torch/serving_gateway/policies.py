"""Pluggable queue disciplines behind one ``SchedulerPolicy`` interface: a copy of
``accelerate_tpu/serving_gateway/policies.py``.

The gateway holds one policy; every queued ``GatewayRequest`` lives inside it between
``submit()`` and admission. A policy never touches the engine or the clock: it is a
priority structure over items exposing ``uid`` / ``priority`` / ``deadline_at`` /
``tenant`` / ``cost`` / ``t_submit``.

- ``fifo`` — arrival order (the bare engine's deque).
- ``priority`` — strict priority with aging: ``priority + waited/aging_s``, so every
  request eventually outranks a stream of fresher high-priority arrivals.
- ``edf`` — earliest deadline first; deadline-less requests rank after every
  deadline-bearing one, FIFO among themselves.
- ``wfq`` — start-time weighted fair queueing across tenants.

``urgency(item, now)`` is each discipline's importance (higher = more urgent); overload
shedding compares a newcomer's urgency with ``shed_candidate()``'s.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterable, Optional

__all__ = [
    "SchedulerPolicy",
    "FifoPolicy",
    "PriorityPolicy",
    "EdfPolicy",
    "WfqPolicy",
    "POLICIES",
    "make_policy",
]


class SchedulerPolicy:
    """One queue discipline. Items are opaque beyond the scheduling attributes
    (see module docstring); insertion uids are unique and monotonically increasing,
    which every tie-break leans on for determinism."""

    name = "base"

    def __init__(self):
        self._items: "OrderedDict[int, object]" = OrderedDict()

    # -------------------------------------------------------------- structure
    def push(self, item) -> None:
        self._items[item.uid] = item

    def remove(self, uid: int):
        """Withdraw by uid BEFORE service (cancellation/shed/expiry); returns the
        item or None. Disciplines with virtual-clock state treat withdrawal as
        never-happened (WFQ refunds the charge) — removal for SERVICE goes
        through :meth:`take`."""
        return self._items.pop(uid, None)

    def take(self, uid: int, now: float):
        """Remove a specific uid FOR SERVICE (targeted admission, e.g. a
        preemptor): like ``pop()`` but by uid, so virtual-clock disciplines
        charge the service instead of refunding it."""
        return self.remove(uid)

    def items(self) -> Iterable:
        """Queued items in insertion order (deadline scans, stats)."""
        return list(self._items.values())

    def __len__(self) -> int:
        return len(self._items)

    # -------------------------------------------------------------- discipline
    def urgency(self, item, now: float) -> float:
        """Importance under this discipline, higher = served sooner. The default
        (FIFO) ranks older arrivals higher."""
        return -item.uid

    def pop(self, now: float):
        """Remove and return the most urgent item (None when empty).
        Ties break toward the lower uid — oldest first, deterministic."""
        if not self._items:
            return None
        best = max(self._items.values(), key=lambda i: (self.urgency(i, now), -i.uid))
        return self._items.pop(best.uid)

    def shed_candidate(self, now: float):
        """The item overload sheds first: the LEAST urgent, ties toward the
        newest arrival (never returns items the discipline would pop next).
        Read-only — the gateway decides whether to actually remove it."""
        if not self._items:
            return None
        return min(self._items.values(), key=lambda i: (self.urgency(i, now), -i.uid))


class FifoPolicy(SchedulerPolicy):
    """Arrival order — the bare engine's deque semantics, made explicit."""

    name = "fifo"


class PriorityPolicy(SchedulerPolicy):
    """Strict priority with linear aging (starvation-free).

    ``effective(item) = item.priority + waited/aging_s``: with ``aging_s=10`` a
    priority-0 request outranks a fresh priority-2 one after 20 s in queue. Pop
    scans the queue (O(n)) — correct under aging, whose effective keys change with
    time and so cannot live in a static heap; gateway queues are thousands of
    entries, not millions."""

    name = "priority"

    def __init__(self, aging_s: float = 10.0):
        super().__init__()
        if aging_s <= 0:
            raise ValueError(f"aging_s={aging_s} must be > 0")
        self.aging_s = aging_s

    def urgency(self, item, now: float) -> float:
        return item.priority + max(0.0, now - item.t_submit) / self.aging_s


class EdfPolicy(SchedulerPolicy):
    """Earliest deadline first. No deadline = infinitely slack: such requests
    rank after every deadline-bearing one and FIFO among themselves (the uid
    tie-break in ``pop``/``shed_candidate``)."""

    name = "edf"

    def urgency(self, item, now: float) -> float:
        if item.deadline_at is None:
            return float("-inf")
        return -item.deadline_at


class WfqPolicy(SchedulerPolicy):
    """Start-time weighted fair queueing (SFQ) across tenants.

    On push an item gets ``start = max(v, tenant_last_finish)`` and
    ``finish = start + cost/weight``; pop serves the minimum finish tag and
    advances the virtual clock ``v`` to the served item's start tag. Tenants
    receive service proportional to weight: a weight-3 tenant's items accrue
    virtual time 3x slower, so bursts from a weight-1 tenant cannot crowd it out.
    Tags are assigned at push and never revised — WFQ is about ordering among
    tenants, not wall-clock aging."""

    name = "wfq"

    def __init__(self, tenant_weights: Optional[Dict[str, float]] = None):
        super().__init__()
        self.tenant_weights = dict(tenant_weights or {})
        for tenant, weight in self.tenant_weights.items():
            if weight <= 0:
                raise ValueError(f"tenant_weights[{tenant!r}]={weight} must be > 0")
        self._v = 0.0                    # virtual clock: start tag of last served item
        self._tenant_finish: Dict[str, float] = {}
        self._tags: Dict[int, tuple] = {}  # uid → (start, finish)

    def push(self, item) -> None:
        weight = self.tenant_weights.get(item.tenant, 1.0)
        start = max(self._v, self._tenant_finish.get(item.tenant, 0.0))
        finish = start + float(item.cost) / weight
        self._tenant_finish[item.tenant] = finish
        self._tags[item.uid] = (start, finish)
        super().push(item)

    def remove(self, uid: int):
        tag = self._tags.pop(uid, None)
        item = super().remove(uid)
        if item is not None and tag is not None:
            start, finish = tag
            if self._tenant_finish.get(item.tenant) == finish:
                # Withdrawn before service (shed/cancel/expiry): refund the virtual
                # service charged at push when it was the tenant's latest item —
                # otherwise a shed-heavy tenant's future items start ever further
                # behind _v and overload inverts its fair share. (Mid-chain
                # removals keep their charge: later tags already embed it.)
                self._tenant_finish[item.tenant] = start
        return item

    def take(self, uid: int, now: float):
        """Serve a specific uid: keep the tenant's service charge and advance the
        virtual clock exactly as ``pop()`` would — a preempting tenant must pay
        for the lane it takes, or routine preemptors would outrun their weight."""
        tag = self._tags.pop(uid, None)
        item = SchedulerPolicy.remove(self, uid)
        if item is not None and tag is not None:
            self._v = max(self._v, tag[0])
        return item

    def urgency(self, item, now: float) -> float:
        tag = self._tags.get(item.uid)
        if tag is None:
            # Not pushed yet (the gateway compares a prospective newcomer against
            # the shed candidate): the tag it WOULD receive, without registering.
            weight = self.tenant_weights.get(item.tenant, 1.0)
            start = max(self._v, self._tenant_finish.get(item.tenant, 0.0))
            tag = (start, start + float(item.cost) / weight)
        return -tag[1]  # smaller finish tag = more urgent

    def pop(self, now: float):
        item = super().pop(now)
        if item is not None:
            start, _ = self._tags.pop(item.uid)
            self._v = max(self._v, start)
        return item


#: name → constructor; ``GatewayConfig.policy`` validates against the same names
#: (``utils.dataclasses._GATEWAY_POLICIES``; paired by a test).
POLICIES = {
    "fifo": FifoPolicy,
    "priority": PriorityPolicy,
    "edf": EdfPolicy,
    "wfq": WfqPolicy,
}


def make_policy(config) -> SchedulerPolicy:
    """Instantiate the policy a :class:`~..utils.dataclasses.GatewayConfig` names,
    threading the discipline-specific knobs (``aging_s``, ``tenant_weights``)."""
    name = config.policy
    if name == "priority":
        return PriorityPolicy(aging_s=config.aging_s)
    if name == "wfq":
        return WfqPolicy(tenant_weights=config.tenant_weights)
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown scheduler policy {name!r}; known: {sorted(POLICIES)}"
        ) from None
