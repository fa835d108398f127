"""Scripted fault injection for the multi-process runtime, the
reference's runtime/failures.py:

  * ``crash_at_round=r``: the party process exits abruptly (``os._exit``,
    no goodbye, no flushing) at the start of local round r. The harness
    respawns it ``rejoin_delay_s`` later with ``resume=True``; it restores
    its block from its latest checkpoint, fast-forwards its private RNG
    stream past the completed rounds and resends any round the server may
    have seen, which the server answers from its reply cache without
    advancing state. That is what makes recovery lossless.
  * ``slow_send_s``: a straggler link. The party sleeps that long before
    each round's uploads. Under the 'serial' schedule everyone waits for
    it (SynREVEL); under 'arrival' only its own rounds are late (AsyREVEL).

A crashed party is respawned at most ``max_rejoins`` times; a party that
keeps dying fails the federation.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# the exit code of a SCRIPTED crash, so the harness can tell fault
# injection from a genuine party failure
CRASH_EXIT_CODE = 37


@dataclass(frozen=True)
class PartyFault:
    crash_at_round: int | None = None
    rejoin_delay_s: float = 0.5
    max_rejoins: int = 1
    slow_send_s: float = 0.0


@dataclass(frozen=True)
class FailurePlan:
    faults: dict = field(default_factory=dict)    # party index -> PartyFault

    def fault_for(self, m: int) -> PartyFault | None:
        return self.faults.get(m)


NO_FAILURES = FailurePlan()
