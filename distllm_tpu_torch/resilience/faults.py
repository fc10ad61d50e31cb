"""Deterministic, seeded fault injection for the serving stack (the port
of ``distllm_tpu.resilience.faults``: the same sites, grammar and firing
schedule, so one ``DISTLLM_FAULTS`` spec arms either package alike).

A registry of **named injection sites** wired into the hazard points of
the engine, the KV tiers and the window loop, armed per site with a
deterministic schedule, and **inert by default**: an unarmed injector is
one boolean read per site visit.

Sites are catalogued in :data:`FAULT_SITES` exactly like
``instruments.FLIGHT_KINDS``: a site not listed there is rejected at
arm/fire time. The wired sites:

- ``dispatch`` — raise :class:`InjectedFault` from a prefill, decode,
  mixed or verify dispatch before anything reaches the device (before the
  pinned copy into a runner's static buffers and before a graph replay);
- ``device_put`` — fail the tier promotion's host-to-device copy (engine
  ``_promote``; degrades to cold prefill);
- ``tier_io`` — raise :class:`OSError` from the disk tier's file
  read/write (``DiskKVTier``; degrades to a tier miss);
- ``sched_exhausted`` — raise ``SchedulerExhausted`` from window
  planning (the pool-pressure hazard without needing a tiny pool);
- ``slow_window`` — sleep ``delay_s`` inside window processing (the
  stall hazard per-request deadlines exist for).

Every fire emits ``distllm_resilience_faults_injected_total{site}`` and
a ``'fault'`` flight record. Determinism: each site fires on an explicit
call schedule (``after`` skipped calls, then up to ``times`` fires) and/or
a seeded per-site ``random.Random`` probability, so the same arming and
the same call sequence reproduce the same fault pattern.

Arming: programmatic (:meth:`FaultInjector.arm`) or the
``DISTLLM_FAULTS`` env var, a comma-separated list of site clauses::

    DISTLLM_FAULTS="dispatch:times=2:after=4,slow_window:delay_s=0.2"

Host Python only (stdlib and the observability modules).
"""

from __future__ import annotations

import os
import random
import threading
import time
from dataclasses import dataclass, field

from distllm_tpu_torch.observability import instruments as _metrics
from distllm_tpu_torch.observability.flight import get_flight_recorder

# Catalog of injectable sites (the FLIGHT_KINDS pattern): arm()/fire()
# reject anything not listed, and docs/resilience.md documents each row.
FAULT_SITES = frozenset({
    'dispatch',         # window/prefill dispatch raise (engine)
    'device_put',       # tier promotion host->device transfer (engine)
    'tier_io',          # disk-tier file IO (kv_cache.DiskKVTier)
    'sched_exhausted',  # scheduler exhaustion during window planning
    'slow_window',      # stall inside window processing
})


class InjectedFault(RuntimeError):
    """The error an armed ``dispatch``/``device_put`` site raises."""

    def __init__(self, site: str, message: str = '') -> None:
        super().__init__(message or f'injected fault at site {site!r}')
        self.site = site


@dataclass
class _SiteState:
    """One armed site's deterministic schedule."""

    site: str
    times: int | None  # max fires; None = unlimited
    prob: float        # per-eligible-call fire probability
    after: int         # eligible calls skipped before firing starts
    delay_s: float     # slow_window sleep per fire
    rng: random.Random = field(default_factory=random.Random)
    calls: int = 0
    fired: int = 0


def parse_fault_spec(spec: str) -> list[dict]:
    """``DISTLLM_FAULTS`` grammar → arm() kwargs, validating site names.

    ``site[:key=value]*`` clauses joined by commas; keys are ``times``
    (int, ``inf``/``-1`` = unlimited), ``prob`` (float), ``after``
    (int), ``delay_s`` (float), ``seed`` (int). Raises ``ValueError``
    on unknown sites/keys — a typo'd chaos schedule must fail loudly,
    not silently run fault-free.
    """
    out: list[dict] = []
    for clause in spec.split(','):
        clause = clause.strip()
        if not clause:
            continue
        parts = clause.split(':')
        site = parts[0].strip()
        if site not in FAULT_SITES:
            raise ValueError(
                f'unknown fault site {site!r}; sites: {sorted(FAULT_SITES)}'
            )
        kwargs: dict = {'site': site}
        for part in parts[1:]:
            key, _, value = part.partition('=')
            key = key.strip()
            value = value.strip()
            if key == 'times':
                kwargs['times'] = (
                    None if value in ('inf', '-1') else int(value)
                )
            elif key == 'prob':
                kwargs['prob'] = float(value)
            elif key == 'after':
                kwargs['after'] = int(value)
            elif key == 'delay_s':
                kwargs['delay_s'] = float(value)
            elif key == 'seed':
                kwargs['seed'] = int(value)
            else:
                raise ValueError(f'unknown fault spec key {key!r}')
        out.append(kwargs)
    return out


class FaultInjector:
    """Process-wide registry of armed fault sites.

    Thread-safe (the engine loop, server threads, and tier IO may hit
    sites concurrently); the unarmed fast path is a single attribute
    read with no lock.
    """

    def __init__(self, env_spec: str | None = None) -> None:
        self._lock = threading.Lock()
        self._sites: dict[str, _SiteState] = {}  # guarded by self._lock
        # Fast inert-path flag; only flipped under the lock, read without
        # it (a stale False just delays the first fire by one visit).
        self._armed = False
        if env_spec:
            for kwargs in parse_fault_spec(env_spec):
                self.arm(**kwargs)

    # ------------------------------------------------------------ arming
    def arm(
        self,
        site: str,
        *,
        times: int | None = 1,
        prob: float = 1.0,
        after: int = 0,
        delay_s: float = 0.0,
        seed: int = 0,
    ) -> None:
        """Arm ``site``: skip the first ``after`` eligible calls, then
        fire (with probability ``prob``, drawn from a ``seed``-determined
        stream) up to ``times`` times (``None`` = forever)."""
        if site not in FAULT_SITES:
            raise ValueError(
                f'unknown fault site {site!r}; sites: {sorted(FAULT_SITES)}'
            )
        if times is not None and times < 0:
            raise ValueError('times must be >= 0 or None')
        if not 0.0 <= prob <= 1.0:
            raise ValueError('prob must be in [0, 1]')
        with self._lock:
            self._sites[site] = _SiteState(
                site=site,
                times=times,
                prob=prob,
                after=max(0, int(after)),
                delay_s=max(0.0, float(delay_s)),
                rng=random.Random(seed),
            )
            self._armed = True

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site (or all of them) — the state (fire counts) is
        discarded with the arming."""
        with self._lock:
            if site is None:
                self._sites.clear()
            else:
                self._sites.pop(site, None)
            self._armed = bool(self._sites)

    @property
    def armed(self) -> bool:
        return self._armed

    def fired(self, site: str | None = None) -> int:
        """Total fires of ``site`` (or all sites) since arming."""
        with self._lock:
            if site is not None:
                state = self._sites.get(site)
                return state.fired if state is not None else 0
            return sum(state.fired for state in self._sites.values())

    # ------------------------------------------------------------ firing
    def fire(self, site: str) -> _SiteState | None:
        """One visit to ``site``: returns the site state when the fault
        fires this visit, None otherwise. Inert default: one boolean
        read. Every fire is counted + flight-recorded."""
        if not self._armed:
            return None
        if site not in FAULT_SITES:
            raise ValueError(f'unknown fault site {site!r}')
        with self._lock:
            state = self._sites.get(site)
            if state is None:
                return None
            state.calls += 1
            if state.calls <= state.after:
                return None
            if state.times is not None and state.fired >= state.times:
                return None
            if state.prob < 1.0 and state.rng.random() >= state.prob:
                return None
            state.fired += 1
            fired, calls = state.fired, state.calls
        _metrics.RESILIENCE_FAULTS.labels(site=site).inc()
        get_flight_recorder().record(
            'fault', site=site, fired=fired, call=calls,
        )
        return state

    def fail(self, site: str, message: str = '') -> None:
        """Raise :class:`InjectedFault` when ``site`` fires this visit."""
        if self.fire(site) is not None:
            raise InjectedFault(site, message)

    def fail_io(self, site: str = 'tier_io') -> None:
        """Raise :class:`OSError` when ``site`` fires — for hazard points
        whose real failure mode is an IO error the caller already
        degrades on (the disk tier's read/write paths)."""
        if self.fire(site) is not None:
            raise OSError(f'injected IO fault at site {site!r}')

    def maybe_sleep(self, site: str = 'slow_window') -> float:
        """Sleep the armed ``delay_s`` when ``site`` fires; returns the
        injected delay (0.0 when nothing fired)."""
        state = self.fire(site)
        if state is None or state.delay_s <= 0:
            return 0.0
        time.sleep(state.delay_s)
        return state.delay_s


_default_injector = FaultInjector(env_spec=os.environ.get('DISTLLM_FAULTS'))


def get_fault_injector() -> FaultInjector:
    """The process-wide injector (env-armed from ``DISTLLM_FAULTS`` at
    import; tests arm/disarm it directly)."""
    return _default_injector
