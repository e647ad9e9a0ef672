"""Continuous-batching scheduler with bucketed plan portfolios.

The port's counterpart of `repro.serving.scheduler`.  The fixed-batch
`ServingEngine` admits a batch, decodes it to completion, then admits the
next: a late arrival waits for the whole batch ahead of it (head-of-line
blocking), and a short request pays for the longest one it was packed
with.  `ContinuousScheduler` replaces that loop with iteration-level
scheduling over a fixed pool of **slots**:

  * every step runs ONE `decode_step` at a fixed (max_batch, 1) shape;
  * each slot carries its own timeline (`pos` is a per-slot vector, see
    `models/layers.attention_decode`): a slot still consuming its prompt
    feeds the next prompt token (chunked prefill, interleaved token by
    token with in-flight decodes), a decoding slot feeds the token it just
    sampled, and a free slot feeds a masked dummy;
  * requests join a free slot the step they arrive (admission ordered by
    `Request.arrival_s`) and leave the step they finish.

The co-execution twist is the **plan portfolio**
(`repro_torch.compile_portfolio`): one `CoexecPlan` per (batch, seq)
bucket.  Each step selects the smallest bucket covering the live
(active-slots, max-position) shape and charges the step to that plan;
every `fidelity_every` steps the bucket's plan is executed on the
scheduler's device (its co-executed nodes on the hand-written kernels),
its records go to the `MeasurementStore`, one `DriftMonitor` per bucket
watches them, and a triggered monitor replans the bucket **in place**
(`CompiledNetwork.replan` on a calibrator fit over the trailing record
window, verified by the static verifier before it is committed).

Time: `clock="virtual"` (default) advances by each step's selected-plan
cost, deterministic and host-independent; `clock="wall"` uses the host
clock (each step ends in a device-to-host copy of the sampled tokens, so
it includes the device's work).  `FixedBatchReference` replays the
fixed-batch engine's admission and batching under the same virtual clock
with a single plan: the baseline the portfolio scheduler must beat.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np

import torch

from repro_torch.core.coexec import resolve_device
from repro_torch.serving.engine import Completion, Request

#: per-step cost (seconds) charged by the virtual clock when no portfolio
#: is attached (a bare scheduler still reports latency percentiles)
DEFAULT_STEP_COST_S = 1e-3


@dataclasses.dataclass
class SchedulerConfig:
    """Knobs of the continuous scheduler (all host-side)."""

    max_batch: int = 4            # slot count = decode batch width
    max_len: int = 128            # per-slot cache length
    clock: str = "virtual"        # "virtual" | "wall"
    seed: int = 0
    fidelity_every: int = 16      # plan-execution cadence, in steps
    fidelity_window: int = 4      # trailing reports a replan's fit sees
    drift_threshold: float = 0.35
    drift_hysteresis: float = 0.15
    drift_cooldown: int = 6

    def __post_init__(self):
        if self.clock not in ("virtual", "wall"):
            raise ValueError(f"unknown clock {self.clock!r}; "
                             f"choices: ['virtual', 'wall']")


@dataclasses.dataclass
class ThrottleSim:
    """Simulated mid-run slowdown (thermal throttle): from `at_s` on the
    scheduler clock, every recorded plan-execution wall time is scaled by
    `scale` — the drift the monitors must catch and replan away."""

    at_s: float
    scale: float = 1.8


@dataclasses.dataclass
class ReplanEvent:
    """One in-place bucket replan, with fidelity error before/after."""

    bucket: str
    time_s: float
    step: int
    old_key: str
    new_key: str
    predicted_gain_us: float
    changes: int
    pre_fidelity: float                  # mean |log(wall/pred)|, trailing
    post_fidelity: Optional[float] = None  # filled by the next execution

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class RequestStats:
    rid: int
    arrival_s: float
    first_token_s: float
    done_s: float
    n_tokens: int

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ttft_s"] = self.ttft_s
        d["latency_s"] = self.latency_s
        return d


def _percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q)) \
        if values else 0.0


@dataclasses.dataclass
class SchedulerReport:
    """Traffic-level outcome of one scheduler run."""

    completions: List[Completion]
    stats: List[RequestStats]
    duration_s: float
    steps: int
    total_tokens: int
    bucket_switches: int
    bucket_steps: Dict[str, int]
    replan_events: List[ReplanEvent]
    clock: str

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.duration_s if self.duration_s else 0.0

    def latency_p(self, q: float) -> float:
        return _percentile([s.latency_s for s in self.stats], q)

    def ttft_p(self, q: float) -> float:
        return _percentile([s.ttft_s for s in self.stats], q)

    def to_json(self) -> Dict[str, Any]:
        return {
            "clock": self.clock,
            "requests": len(self.stats),
            "duration_s": self.duration_s,
            "steps": self.steps,
            "total_tokens": self.total_tokens,
            "tokens_per_s": self.tokens_per_s,
            "latency_p50_s": self.latency_p(50),
            "latency_p99_s": self.latency_p(99),
            "ttft_p50_s": self.ttft_p(50),
            "ttft_p99_s": self.ttft_p(99),
            "bucket_switches": self.bucket_switches,
            "bucket_steps": dict(self.bucket_steps),
            "replan_events": [e.to_json() for e in self.replan_events],
        }

    def summary(self) -> str:
        lines = [
            f"served {len(self.stats)} requests / {self.total_tokens} "
            f"tokens in {self.duration_s:.3f}s ({self.clock} clock) — "
            f"{self.tokens_per_s:.1f} tok/s over {self.steps} steps",
            f"  latency p50 {self.latency_p(50):.3f}s  "
            f"p99 {self.latency_p(99):.3f}s | ttft p50 "
            f"{self.ttft_p(50):.3f}s  p99 {self.ttft_p(99):.3f}s",
        ]
        if self.bucket_steps:
            per = " ".join(f"{tag}:{n}" for tag, n in
                           sorted(self.bucket_steps.items()))
            lines.append(f"  bucket switches: {self.bucket_switches} "
                         f"(steps per bucket: {per})")
        for e in self.replan_events:
            post = (f"{e.post_fidelity:.3f}" if e.post_fidelity is not None
                    else "pending")
            lines.append(
                f"  replan [{e.bucket}] @ {e.time_s:.3f}s: "
                f"{e.changes} ops moved, predicted gain "
                f"{e.predicted_gain_us:.1f} us, fidelity err "
                f"{e.pre_fidelity:.3f} -> {post}")
        return "\n".join(lines)


class _Slot:
    """One in-flight request bound to a batch row."""

    __slots__ = ("req", "pos", "out", "cur", "admitted_s", "first_token_s")

    def __init__(self, req: Request, now: float):
        self.req = req
        self.pos = 0                  # next cache position to write
        self.out: List[int] = []
        self.cur: Optional[int] = None  # last sampled token
        self.admitted_s = now
        self.first_token_s: Optional[float] = None

    @property
    def prefilling(self) -> bool:
        return self.pos < len(self.req.prompt)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.req.max_new_tokens


class ContinuousScheduler:
    """Iteration-level scheduler over a fixed slot pool (see module doc).

    `model` must support per-slot position vectors
    (`model.per_slot_pos`, the GQA attention path) — each slot runs its
    own timeline in the shared cache, which is what makes join/evict
    correct without any re-prefill or padding.  The model's params, its
    cache, the sampling generator and every plan execution live on
    `device` (CUDA unless the caller passes another).
    """

    def __init__(self, cfg, model, params, *,
                 config: Optional[SchedulerConfig] = None,
                 portfolio=None, measurement_store=None,
                 throttle: Optional[ThrottleSim] = None,
                 plan_cache=None, device=None):
        if not getattr(model, "per_slot_pos", False):
            raise ValueError(
                "ContinuousScheduler needs per-slot position support "
                "(model.per_slot_pos — the gqa attention path); recurrent "
                "and MLA stacks serve through the fixed-batch "
                "ServingEngine instead")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model
        self.params = params
        self.config = config or SchedulerConfig()
        self.portfolio = portfolio
        if measurement_store is not None and \
                not hasattr(measurement_store, "append"):
            from repro_torch.measure import MeasurementStore
            measurement_store = MeasurementStore(measurement_store)
        self.store = measurement_store
        self.throttle = throttle
        self.plan_cache = plan_cache   # replanned plans land here (None =
        #                                the compile-time default cache dir)
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.config.seed)
        # per-bucket drift state (portfolio mode)
        self._monitors: Dict[Any, Any] = {}
        self._recent_reports: Dict[Any, List[Any]] = {}
        self._fid_log: Dict[Any, List[float]] = {}
        self.replan_events: List[ReplanEvent] = []

    # -------------------------------------------------------------- fidelity
    def _monitor(self, bucket):
        if bucket not in self._monitors:
            from repro_torch.measure import DriftMonitor
            c = self.config
            self._monitors[bucket] = DriftMonitor(
                threshold=c.drift_threshold, hysteresis=c.drift_hysteresis,
                window=c.fidelity_window, baseline=c.fidelity_window,
                cooldown=c.drift_cooldown)
        return self._monitors[bucket]

    def _throttle_scale(self, now: float) -> float:
        if self.throttle is not None and now >= self.throttle.at_s:
            return self.throttle.scale
        return 1.0

    def _profile_scaled(self, compiled, now: float):
        """One steady-state plan execution with any active throttle
        applied to the recorded wall times (the metrics on the report
        compute lazily from the timings, so scaling propagates)."""
        report = compiled.profile(device=self.device, warmup=True)
        scale = self._throttle_scale(now)
        if scale != 1.0:
            for t in report.timings:
                t.wall_us *= scale
        return report

    def _observe_fidelity(self, bucket, compiled, now: float,
                          step: int) -> None:
        """Execute the bucket's plan once, append the (throttle-scaled)
        records to the store, and feed the bucket's drift monitor —
        replanning in place when it fires."""
        report = self._profile_scaled(compiled, now)
        if self.store is not None:
            self.store.append(report)
        window = self._recent_reports.setdefault(bucket, [])
        window.append(report)
        del window[:-self.config.fidelity_window]
        self._fid_log.setdefault(bucket, []).append(report.fidelity_error())
        ratio = report.mean_log_ratio()
        if ratio is None:
            return
        if self._monitor(bucket).observe(ratio) and \
                self.portfolio is not None and self.portfolio.can_replan():
            self._replan(bucket, compiled, now, step)

    def _replan(self, bucket, compiled, now: float, step: int) -> None:
        """In-place bucket repair, validated before commit.

        The calibrator is fit on the newest half of the record window —
        at trigger time the trailing median has crossed, so the most
        recent reports are the ones describing the drifted regime (older
        ones describe a device state that no longer exists).  Records
        carry the *current plan's* predictions, so when that plan already
        embeds a calibration the fresh fit is composed with it
        (`Calibrator.compose`) to stay valid on raw predictor output.
        The repaired plan is executed once before commit: if its fidelity
        error is not actually lower than the trailing window's (a noise
        trigger), the old plan keeps serving and only the monitor resets."""
        from repro_torch.measure import Calibrator
        window = self._recent_reports.get(bucket, [])
        recent = window[-max(2, self.config.fidelity_window // 2):]
        records = [t for rep in recent for t in rep.timings]
        if not records:
            return
        cal = Calibrator.fit(records).compose(
            getattr(compiled, "calibration", None))
        if self.plan_cache is not None:
            new_compiled, diff = compiled.replan(cal, cache=self.plan_cache)
        else:
            new_compiled, diff = compiled.replan(cal)
        # static verification gate: a calibration-induced illegal decision
        # must never reach the slot pool.  On error diagnostics the old
        # plan keeps serving; the monitor still resets so the same drifted
        # window cannot re-trigger a doomed replan every step.
        from repro_torch.analysis import errors as diag_errors
        from repro_torch.analysis import verify_plan
        bad = diag_errors(verify_plan(new_compiled.plan, stats=False))
        if bad:
            import logging
            logging.getLogger("repro_torch.serving").warning(
                "replan for %s rejected by static verification: %s",
                bucket.tag, bad[0])
            self._monitor(bucket).reset()
            self._recent_reports[bucket] = []
            self._fid_log[bucket] = []
            return
        pre = float(np.mean(self._fid_log[bucket]
                            [-self.config.fidelity_window:]))
        post_report = self._profile_scaled(new_compiled, now)
        post = post_report.fidelity_error()
        # new baseline either way: the drifted window must not re-trigger
        self._monitor(bucket).reset()
        self._recent_reports[bucket] = []
        self._fid_log[bucket] = []
        if post >= pre:
            return                     # repair didn't help: keep old plan
        self.portfolio.replace(bucket, new_compiled)
        if self.store is not None:
            self.store.append(post_report)
        self._recent_reports[bucket] = [post_report]
        self._fid_log[bucket] = [post]
        self.replan_events.append(ReplanEvent(
            bucket=bucket.tag, time_s=now, step=step,
            old_key=diff.old_key, new_key=diff.new_key,
            predicted_gain_us=diff.predicted_gain_us,
            changes=len(diff.changes), pre_fidelity=pre,
            post_fidelity=post))

    # ------------------------------------------------------------------ run
    def run(self, requests: List[Request]) -> SchedulerReport:
        from repro_torch.serving.engine import sample_tokens

        cfg = self.config
        for r in requests:
            need = len(r.prompt) + r.max_new_tokens
            if need > cfg.max_len:
                raise ValueError(
                    f"request {r.rid}: prompt + max_new_tokens = {need} "
                    f"exceeds max_len={cfg.max_len}")
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        pending.reverse()                      # pop() from the tail
        slots: List[Optional[_Slot]] = [None] * cfg.max_batch
        cache = self.model.init_cache(cfg.max_batch, cfg.max_len,
                                      device=self.device)

        completions: List[Completion] = []
        stats: List[RequestStats] = []
        now = 0.0
        start_s = now
        steps = 0
        total_tokens = 0
        bucket_switches = 0
        bucket_steps: Dict[str, int] = {}
        last_bucket = None
        wall_anchor = time.perf_counter()

        while pending or any(s is not None for s in slots):
            # ---------------------------------------------------- admission
            if all(s is None for s in slots) and pending and \
                    pending[-1].arrival_s > now:
                now = pending[-1].arrival_s    # idle: fast-forward
            for i in range(cfg.max_batch):
                if slots[i] is None and pending and \
                        pending[-1].arrival_s <= now:
                    slots[i] = _Slot(pending.pop(), now)
            active = [i for i, s in enumerate(slots) if s is not None]
            if not active:
                continue

            # ---------------------------------------------- bucket selection
            bucket, compiled = None, None
            if self.portfolio is not None:
                live_b = len(active)
                live_seq = max(slots[i].pos + 1 for i in active)
                bucket, compiled = self.portfolio.select(live_b, live_seq)
                tag = bucket.tag
                bucket_steps[tag] = bucket_steps.get(tag, 0) + 1
                if last_bucket is not None and bucket != last_bucket:
                    bucket_switches += 1
                last_bucket = bucket

            # ------------------------------------------------- decode step
            toks = np.zeros((cfg.max_batch, 1), np.int32)
            pos = np.zeros((cfg.max_batch,), np.int32)
            temps = np.zeros((cfg.max_batch,), np.float32)
            for i in active:
                s = slots[i]
                if s.prefilling:
                    toks[i, 0] = int(s.req.prompt[s.pos])
                else:
                    toks[i, 0] = s.cur
                    temps[i] = s.req.temperature
                pos[i] = s.pos
            logits, cache = self.model.decode_step(
                self.params, torch.from_numpy(toks).to(self.device), cache,
                torch.from_numpy(pos).to(self.device))
            # sampling temperature applies only to rows past their prompt;
            # rows mid-prefill (and free rows) stay greedy so they never
            # draw from the generator: admission order cannot shift another
            # request's sampled tokens
            sampled, self.generator = sample_tokens(self.generator, logits,
                                                    temps)
            sampled = sampled.tolist()
            steps += 1

            # ----------------------------------------------------- advance
            if cfg.clock == "virtual":
                if compiled is not None and \
                        compiled.plan.end_to_end_us is not None:
                    now += compiled.plan.end_to_end_us * 1e-6
                else:
                    now += DEFAULT_STEP_COST_S
            else:
                t1 = time.perf_counter()
                now += t1 - wall_anchor
                wall_anchor = t1

            for i in active:
                s = slots[i]
                emits = s.pos >= len(s.req.prompt) - 1   # last prompt tok
                s.pos += 1
                if not emits:
                    continue
                s.cur = int(sampled[i])
                s.out.append(s.cur)
                total_tokens += 1
                if s.first_token_s is None:
                    s.first_token_s = now
                if s.done:
                    completions.append(Completion(s.req.rid, s.out))
                    stats.append(RequestStats(
                        rid=s.req.rid, arrival_s=s.req.arrival_s,
                        first_token_s=s.first_token_s, done_s=now,
                        n_tokens=len(s.out)))
                    slots[i] = None

            # ---------------------------------------------------- fidelity
            if compiled is not None and steps % cfg.fidelity_every == 0:
                self._observe_fidelity(bucket, compiled, now, steps)

        return SchedulerReport(
            completions=completions, stats=stats,
            duration_s=now - start_s, steps=steps,
            total_tokens=total_tokens, bucket_switches=bucket_switches,
            bucket_steps=bucket_steps, replan_events=self.replan_events,
            clock=cfg.clock)


class FixedBatchReference:
    """The fixed-batch engine's scheduling semantics replayed under the
    scheduler's virtual clock with ONE plan for every step — the baseline
    the portfolio scheduler is compared against.

    Token-for-token it mirrors `ServingEngine.run`: requests are packed
    into arrival-order batches of `max_batch`, each batch bulk-prefills
    to the longest member's length (padded rows pay for pad positions)
    and decodes until its longest member finishes, and the next batch
    cannot start before the previous one ends (head-of-line blocking).
    Costs come from the single `CompiledNetwork` — the portfolio
    degenerate case bucket-count = 1 — so the comparison isolates what
    bucketed plans + iteration-level scheduling buy at identical arrival
    traffic.  No model forward runs: the reference prices schedules, it
    does not sample tokens (`run` returns stats, not completions).
    """

    def __init__(self, compiled, *, max_batch: int = 4):
        self.compiled = compiled
        self.max_batch = max_batch

    def _step_cost_s(self) -> float:
        e2e = self.compiled.plan.end_to_end_us
        return e2e * 1e-6 if e2e is not None else DEFAULT_STEP_COST_S

    def run(self, requests: List[Request]) -> SchedulerReport:
        order = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        cost = self._step_cost_s()
        now = 0.0
        stats: List[RequestStats] = []
        steps = 0
        total_tokens = 0
        for i in range(0, len(order), self.max_batch):
            batch = order[i:i + self.max_batch]
            # the engine blocks until the whole batch has arrived, then
            # until the previous batch drained
            now = max(now, max(r.arrival_s for r in batch))
            t = max(len(r.prompt) for r in batch)
            now += t * cost                       # padded bulk prefill
            steps += t
            first_token_s = now
            max_new = max(r.max_new_tokens for r in batch)
            done_at = {}
            for k in range(1, max_new + 1):       # k tokens emitted
                for r in batch:
                    if r.max_new_tokens == k:
                        done_at[r.rid] = now + (k - 1) * cost
                if k < max_new:
                    steps += 1
            now += (max_new - 1) * cost           # decode to the longest
            for r in batch:
                done = done_at.get(r.rid, now)
                stats.append(RequestStats(
                    rid=r.rid, arrival_s=r.arrival_s,
                    first_token_s=first_token_s, done_s=done,
                    n_tokens=r.max_new_tokens))
                total_tokens += r.max_new_tokens
        return SchedulerReport(
            completions=[], stats=stats, duration_s=now, steps=steps,
            total_tokens=total_tokens, bucket_switches=0,
            bucket_steps={}, replan_events=[], clock="virtual")


def poisson_requests(n: int, *, rate: float, vocab_size: int,
                     prompt_lens=(4, 8, 16), max_new=(4, 8, 16),
                     temperatures=(0.0, 0.0, 0.7), seed: int = 0
                     ) -> List[Request]:
    """Synthetic traffic: `n` requests with exponential inter-arrival
    times at `rate` req/s and mixed prompt lengths / generation budgets /
    temperatures — the workload generator shared by the serving bench,
    the CLI, and the CI smoke."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out: List[Request] = []
    for rid in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(1, vocab_size,
                                int(rng.choice(prompt_lens))
                                ).astype(np.int32),
            max_new_tokens=int(rng.choice(max_new)),
            temperature=float(rng.choice(temperatures)),
            arrival_s=t))
    return out
