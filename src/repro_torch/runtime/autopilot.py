"""Closed-loop SLA autopilot: precision degradation + overload shedding.

The serving stack exposes every mechanism this controller needs —
``set_precision`` switches MSB-prefix tiers with zero requantization
(DESIGN.md §6), plane compaction makes narrow tiers cheap (§7), and the
scrub path reports integrity pressure (§9) — but until now the dial was
turned by hand. :class:`Autopilot` closes the loop: it watches queue
depth, per-token decode latency (EWMA over wall time per emitted token),
the scrub counter, and a shadow-KL quality proxy, and drives a
hysteresis state machine over the precision ladder (8→6→4 down under
sustained pressure, back up only after a cooldown with headroom). When
even the lowest tier cannot hold the SLA it escalates to load shedding:
typed :class:`OverloadError` admission rejection plus deadline-aware
eviction of the queue tail via :meth:`Autopilot.shed_victims`.

Everything here is pure host-side Python — no torch imports — so the
control law is unit-testable without a device. It is the reference's
``src/repro/runtime/autopilot.py``, kept as the port's own copy. The engine integration
(per-slot tier contracts, mixed-tier decode) lives in
``launch/serve.py``; the control-loop contract is DESIGN.md §10.

Units: the controller runs once per engine iteration ("step"). Queue
depth and the shedding budget are measured in steps (deterministic,
CI-reproducible); ``sla_ms`` is wall-clock milliseconds per emitted
token (the real-deployment signal). Either signal can drive descent.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.runtime.scheduler import AdmissionError, Request

#: ladder served by MSB-prefix truncation of one stored 8-bit
#: decomposition — descending, (a_bits, w_bits) per tier
DEFAULT_TIERS: tuple = ((8, 8), (6, 6), (4, 4))


class OverloadError(AdmissionError):
    """The engine is shedding load: new admissions are rejected so the
    requests already accepted keep their latency bound. Subclasses
    :class:`AdmissionError` so frontends that already handle typed
    admission rejection catch this without new plumbing."""


@dataclasses.dataclass(frozen=True)
class AutopilotPolicy:
    """Control law for :class:`Autopilot`. Frozen: the policy is the
    compile-time contract, the controller carries the mutable state.

    ``tiers`` is the precision ladder, widest first; every entry must be
    servable by MSB-prefix truncation from the stored decomposition
    (the engine validates against the plan registry at bind time).

    Pressure is ``queue_depth >= depth_high`` or per-token latency EWMA
    above ``sla_ms``; headroom is ``queue_depth <= depth_low`` and
    latency at most ``upgrade_margin`` of the SLA. Descent needs
    ``degrade_patience`` consecutive pressured steps, ascent needs
    ``upgrade_patience`` consecutive headroom steps, and any switch
    starts a ``cooldown_steps`` refractory window — three separate
    anti-flap guards because the input signals are noisy in different
    ways (depth is bursty, latency is auto-correlated).

    ``scrub_degrade_after``/``scrub_degrade_to`` fold the engine's one-shot
    scrub hook (``degrade_after``) into the same state machine: a scrub storm jumps straight
    to the first tier at most ``scrub_degrade_to`` bits wide (narrower
    planes = fewer words exposed to upsets), bypassing patience but not
    the tier-contract invariant.

    ``kl_budget`` is the quality guard: when the shadow-KL EWMA already
    exceeds it, the controller refuses to descend further — overload
    then escalates to shedding instead of silently trading more
    accuracy.
    """

    tiers: tuple = DEFAULT_TIERS
    sla_queue_steps: Optional[int] = None  # p99 queue-wait budget (steps)
    sla_ms: Optional[float] = None  # per-emitted-token latency SLA
    depth_high: Optional[int] = None  # None = engine substitutes n_slots
    depth_low: int = 0
    degrade_patience: int = 3
    upgrade_patience: int = 8
    cooldown_steps: int = 12
    upgrade_margin: float = 0.5  # latency must sit below margin*sla to ascend
    shadow_frac: float = 0.0  # fraction of decode steps shadow-scored
    kl_budget: Optional[float] = None
    ewma_alpha: float = 0.25
    shed: bool = True  # allow the shedding ladder past the lowest tier
    scrub_degrade_after: Optional[int] = None
    scrub_degrade_to: int = 4

    def __post_init__(self):
        if not self.tiers:
            raise ValueError("autopilot needs a non-empty tier ladder")
        for a, w in self.tiers:
            if not (1 <= a <= 16 and 1 <= w <= 16):
                raise ValueError(f"tier ({a},{w}) outside the 1..16-bit range")
        widths = [w for _, w in self.tiers]
        if widths != sorted(widths, reverse=True):
            raise ValueError(f"tiers must be widest-first, got {self.tiers}")
        if not 0.0 <= self.shadow_frac <= 1.0:
            raise ValueError("shadow_frac must be in [0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if self.degrade_patience < 1 or self.upgrade_patience < 1:
            raise ValueError("patience thresholds must be >= 1")
        if self.cooldown_steps < 0:
            raise ValueError("cooldown_steps must be >= 0")


@dataclasses.dataclass(frozen=True)
class AutopilotDecision:
    """One control-loop verdict: the tier new admissions contract to,
    whether this step switched (and why), and whether the shedding
    ladder is active (new submits raise :class:`OverloadError` and the
    queue tail is eligible for eviction)."""

    tier: tuple  # (a_bits, w_bits) for new admissions
    tier_index: int
    switched: bool = False
    reason: str = ""
    shed_active: bool = False


class Autopilot:
    """Hysteresis state machine over the precision ladder.

    Call :meth:`observe` once per engine iteration with that step's
    signals; it returns an :class:`AutopilotDecision`. The decision's
    tier applies to *new admissions only* — in-flight requests keep the
    tier they were admitted at (the per-request contract the mixed-tier
    decode path honors), so a switch never changes tokens already
    promised at a wider width.
    """

    def __init__(self, policy: AutopilotPolicy, n_slots: int = 1):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.policy = policy
        self.n_slots = n_slots
        self._idx = 0
        self._pressure_run = 0
        self._headroom_run = 0
        self._last_switch_step: Optional[int] = None
        self._lat_ewma_ms: Optional[float] = None
        self._kl_ewma: Optional[float] = None
        self._shed_active = False
        self.switches: list = []  # (step, tier, reason) audit trail

    # -- read side ----------------------------------------------------------

    @property
    def tier(self) -> tuple:
        return self.policy.tiers[self._idx]

    @property
    def tier_index(self) -> int:
        return self._idx

    @property
    def latency_ewma_ms(self) -> Optional[float]:
        return self._lat_ewma_ms

    @property
    def shadow_kl_ewma(self) -> Optional[float]:
        return self._kl_ewma

    @property
    def shedding(self) -> bool:
        return self._shed_active

    def _depth_high(self) -> Optional[int]:
        if self.policy.depth_high is not None:
            return self.policy.depth_high
        # auto: a full batch of arrived-but-unserved requests is pressure
        if self.policy.sla_ms is not None or self.policy.sla_queue_steps is not None:
            return self.n_slots
        return None  # pure-scrub policy (degrade_after alias): depth ignored

    # -- control law --------------------------------------------------------

    def observe(
        self,
        step: int,
        queue_depth: int,
        *,
        scrubs: int = 0,
        step_latency_s: float = float("nan"),
        tokens_emitted: int = 0,
        shadow_kl: Optional[float] = None,
    ) -> AutopilotDecision:
        """Advance the state machine one engine iteration.

        ``scrubs`` is the *cumulative* engine scrub count (the
        engine's ``scrubs`` counter), ``step_latency_s`` the wall time of this iteration and
        ``tokens_emitted`` how many tokens it produced (0 = pure
        prefill/bookkeeping step, latency is then not per-token
        attributable and is skipped). ``shadow_kl`` is this step's
        shadow-probe KL vs the widest tier, when one was taken.
        """
        pol = self.policy
        if tokens_emitted > 0 and math.isfinite(step_latency_s):
            per_tok_ms = 1e3 * step_latency_s / tokens_emitted
            if self._lat_ewma_ms is None:
                self._lat_ewma_ms = per_tok_ms
            else:
                a = pol.ewma_alpha
                self._lat_ewma_ms = a * per_tok_ms + (1 - a) * self._lat_ewma_ms
        if shadow_kl is not None and math.isfinite(shadow_kl):
            if self._kl_ewma is None:
                self._kl_ewma = float(shadow_kl)
            else:
                a = pol.ewma_alpha
                self._kl_ewma = a * float(shadow_kl) + (1 - a) * self._kl_ewma

        # scrub storm: fold of the degrade_after/degrade_to hook —
        # immediate (no patience). The scrub counter is cumulative, so
        # past the threshold the ladder stays capped at the scrub tier:
        # the one-way semantics the old degrade_after kwarg promised.
        scrub_cap = 0  # widest tier index the scrub rule allows
        if pol.scrub_degrade_after is not None and scrubs >= pol.scrub_degrade_after:
            scrub_cap = next(
                (
                    i
                    for i, (_, w) in enumerate(pol.tiers)
                    if w <= pol.scrub_degrade_to
                ),
                len(pol.tiers) - 1,
            )
            if scrub_cap > self._idx:
                return self._switch(
                    step, scrub_cap, f"scrub storm ({scrubs} scrubs)"
                )

        depth_high = self._depth_high()
        lat_over = (
            pol.sla_ms is not None
            and self._lat_ewma_ms is not None
            and self._lat_ewma_ms > pol.sla_ms
        )
        depth_over = depth_high is not None and queue_depth >= depth_high
        pressure = lat_over or depth_over

        lat_ok = pol.sla_ms is None or (
            self._lat_ewma_ms is not None
            and self._lat_ewma_ms <= pol.upgrade_margin * pol.sla_ms
        )
        headroom = queue_depth <= pol.depth_low and lat_ok

        if pressure:
            self._pressure_run += 1
            self._headroom_run = 0
        elif headroom:
            self._headroom_run += 1
            self._pressure_run = 0
        else:
            self._pressure_run = 0
            self._headroom_run = 0

        in_cooldown = (
            self._last_switch_step is not None
            and step - self._last_switch_step < pol.cooldown_steps
        )
        kl_blocked = (
            pol.kl_budget is not None
            and self._kl_ewma is not None
            and self._kl_ewma > pol.kl_budget
        )

        if self._pressure_run >= pol.degrade_patience and not in_cooldown:
            if self._idx + 1 < len(pol.tiers) and not kl_blocked:
                why = "latency over SLA" if lat_over else "queue depth high"
                return self._switch(step, self._idx + 1, why)
            # bottom of the ladder (or quality-blocked): escalate to shedding
            if pol.shed:
                self._shed_active = True
                why = "quality budget spent" if kl_blocked else "lowest tier"
                return AutopilotDecision(
                    tier=self.tier,
                    tier_index=self._idx,
                    shed_active=True,
                    reason=f"shedding: sustained pressure at {why}",
                )
        if self._headroom_run >= pol.upgrade_patience and not in_cooldown:
            if self._shed_active:
                # leave the shedding state first, then climb tiers
                self._shed_active = False
                self._headroom_run = 0
                return AutopilotDecision(
                    tier=self.tier,
                    tier_index=self._idx,
                    reason="shedding lifted: sustained headroom",
                )
            if self._idx > scrub_cap:  # never climb above the scrub cap
                return self._switch(step, self._idx - 1, "sustained headroom")

        return AutopilotDecision(
            tier=self.tier, tier_index=self._idx, shed_active=self._shed_active
        )

    def force(self, step: int, tier: tuple) -> AutopilotDecision:
        """External (scheduled / operator) switch routed through the
        controller so the ladder state stays consistent: snaps to the
        rung matching ``tier`` exactly, else the widest rung no wider
        than it. Resets patience and starts the cooldown like any other
        switch — a scheduled move must not be immediately fought by the
        control law."""
        tiers = self.policy.tiers
        idx = next((i for i, t in enumerate(tiers) if tuple(t) == tuple(tier)), None)
        if idx is None:
            idx = next(
                (i for i, (_, w) in enumerate(tiers) if w <= tier[1]),
                len(tiers) - 1,
            )
        if idx == self._idx:
            return AutopilotDecision(
                tier=self.tier, tier_index=self._idx,
                shed_active=self._shed_active,
            )
        return self._switch(step, idx, "scheduled switch")

    def _switch(self, step: int, idx: int, reason: str) -> AutopilotDecision:
        direction = "degrade" if idx > self._idx else "upgrade"
        self._idx = idx
        self._last_switch_step = step
        self._pressure_run = 0
        self._headroom_run = 0
        if direction == "upgrade":
            self._shed_active = False
        self.switches.append((step, self.tier, f"{direction}: {reason}"))
        return AutopilotDecision(
            tier=self.tier,
            tier_index=idx,
            switched=True,
            reason=f"{direction}: {reason}",
            shed_active=self._shed_active,
        )

    # -- shedding ladder ----------------------------------------------------

    def shed_victims(
        self,
        waiting: Sequence[Request],
        step: int,
        *,
        service_estimate: int,
    ) -> list:
        """Deadline-aware queue-tail eviction: walk the arrived queue in
        order and predict each request's wait as ``already_waited +
        (queue_position // n_slots + 1) * service_estimate`` steps. A
        request whose prediction exceeds its budget — the tighter of the
        policy's ``sla_queue_steps`` and its own deadline headroom — can
        never be served in time; evicting it now converts a guaranteed
        deadline miss into a fast typed failure and shortens everyone
        behind it. Returns rids to shed (tail-biased by construction:
        later positions predict longer waits)."""
        if service_estimate < 1:
            raise ValueError("service_estimate must be >= 1 step")
        victims = []
        position = 0
        for req in waiting:
            predicted = (step - req.arrival_step) + (
                position // self.n_slots + 1
            ) * service_estimate
            budget = math.inf
            if self.policy.sla_queue_steps is not None:
                budget = float(self.policy.sla_queue_steps)
            if req.deadline_step is not None:
                # wait must leave room to decode before the deadline
                budget = min(budget, float(req.deadline_step - step - 1))
            if predicted > budget:
                victims.append(req.rid)
            else:
                position += 1  # survivors keep their queue position
        return victims
