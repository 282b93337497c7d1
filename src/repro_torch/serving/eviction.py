"""HBM-budgeted eviction over device-resident serving plans.

Admission stages a plan's tiles to the device once; with thousands of
resident matrices the staged bytes are the scarce resource, not the host
copies.  :class:`LRUEvictor` keeps the **device** footprint under a byte
budget: every admission (and every transparent re-stage) charges the
plan's device bytes, and when the budget overflows the least-recently-
*used* plans are unstaged — their device arrays dropped, their host tiles
and autotuned geometry kept, so a later request against an evicted plan
re-stages in one ``device_tiles`` call with zero re-preprocessing (the
partition config is still in the plan, and a full re-admission would hit
the ``.hbp_autotune/`` disk cache by content hash anyway).

Transpose pairs linked by ``admit_pair`` are evicted as a unit — a
forward plan without its backward partner would silently re-stage the
partner on the first training step, defeating the budget accounting.

The policy is pure bookkeeping (names and byte counts); the registry owns
the actual staging/unstaging side effects.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["plan_device_bytes", "LRUEvictor"]


def plan_device_bytes(staged) -> int:
    """Device bytes one plan's staged tiles occupy.

    ``staged`` is the plan's :class:`~repro_torch.kernels.ops.DeviceTiles`:
    the sum of its tensors' ``nbytes`` (tile payloads and columns, the
    per-tile indices, the int64 row permutation and the run index).
    """
    return int(staged.nbytes)


class LRUEvictor:
    """Least-recently-used byte-budget policy over resident plan names.

    ``admit(name, nbytes)`` registers (or re-registers) a plan as the
    most recently used and returns the names that must be unstaged to get
    back under ``budget_bytes`` — oldest first, never the plan just
    admitted (a single plan larger than the whole budget stays resident
    and the evictor reports the overshoot via :meth:`over_budget`).
    ``touch(name)`` refreshes recency on every registry ``get``;
    ``drop(name)`` removes a plan the registry unstaged or fully evicted
    for its own reasons (pair partners, explicit evicts).
    """

    def __init__(self, budget_bytes: int):
        """Create a policy holding device residency under ``budget_bytes``."""
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be > 0, got {budget_bytes}")
        self.budget_bytes = int(budget_bytes)
        # insertion order == recency order (Python dicts preserve it);
        # values are the charged device bytes
        self._resident: Dict[str, int] = {}
        self._pair: Dict[str, str] = {}

    # --- bookkeeping -------------------------------------------------------

    @property
    def resident_bytes(self) -> int:
        """Total device bytes currently charged."""
        return sum(self._resident.values())

    def resident(self) -> List[str]:
        """Resident plan names, least recently used first."""
        return list(self._resident)

    def over_budget(self) -> int:
        """Bytes past the budget, 0 when under.

        Positive only when a single resident unit exceeds the whole
        budget (such a unit stays resident rather than thrashing).
        """
        return max(0, self.resident_bytes - self.budget_bytes)

    def link(self, a: str, b: str) -> None:
        """Mark ``a`` and ``b`` as a transpose pair evicted as one unit."""
        if a != b:
            self._pair[a] = b
            self._pair[b] = a

    def touch(self, name: str) -> None:
        """Refresh ``name`` (and its pair partner) as most recently used."""
        for n in self._unit(name):
            nbytes = self._resident.pop(n, None)
            if nbytes is not None:
                self._resident[n] = nbytes

    def drop(self, name: str) -> None:
        """Forget ``name`` (registry unstaged or evicted it out of band)."""
        self._resident.pop(name, None)

    def unlink(self, name: str) -> None:
        """Dissolve ``name``'s pair link (full eviction of one side)."""
        partner = self._pair.pop(name, None)
        if partner is not None:
            self._pair.pop(partner, None)

    # --- the policy --------------------------------------------------------

    def admit(self, name: str, nbytes: int) -> List[str]:
        """Charge ``name`` at ``nbytes`` and return the victims to unstage.

        The admitted plan (and its pair partner, if resident) is pinned
        for this decision; victims come least recently used first, each
        expanded to its full pair unit, until the total fits the budget
        or nothing evictable remains.
        """
        self._resident.pop(name, None)
        self._resident[name] = int(nbytes)
        pinned = set(self._unit(name))
        victims: List[str] = []
        while self.resident_bytes > self.budget_bytes:
            candidate = next(
                (n for n in self._resident if n not in pinned), None
            )
            if candidate is None:
                break  # only the pinned unit remains: allow the overshoot
            for n in self._unit(candidate):
                if n in self._resident:
                    del self._resident[n]
                    victims.append(n)
        return victims

    def _unit(self, name: str) -> List[str]:
        """``name`` plus its pair partner — the unit evictions operate on."""
        partner: Optional[str] = self._pair.get(name)
        return [name] if partner is None else [name, partner]

    def snapshot(self) -> dict:
        """Bookkeeping view for stats/tests (bytes, order, budget)."""
        return {
            "budget_bytes": self.budget_bytes,
            "resident_bytes": self.resident_bytes,
            "resident": list(self._resident),
            "over_budget": self.over_budget(),
        }
