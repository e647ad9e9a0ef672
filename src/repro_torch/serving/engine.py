"""Batched serving engine: request queue -> prefill -> decode loop.

The port's counterpart of `repro.serving.engine`.  Requests arrive with
prompts (and, for an encoder-decoder, frames), are packed into a fixed
batch (left-padded, with a per-row `start` for pad-aware models),
prefilled once, then decoded step by step with per-request greedy or
temperature sampling until each request's token budget is spent.  Everything runs on one torch device: CUDA unless
the caller passes `device="cpu"`.

An engine can ship a `repro_torch.CompiledNetwork` (`compiled=`) or a
bare `CoexecPlan` (`coexec_plan=`): the offline partitioning artifact
travels with the model, and `execute_plan()` runs it through the port's
`PlanExecutor` on the engine's device (the co-executed nodes on the
hand-written kernels), keeping the per-node fidelity report on
`engine.last_execution_report`.  With `measurement_store=` every
`execute_plan` appends its records to the store, and `engine.drift`
exposes how far the executed-vs-predicted log-ratio has moved.

Each batch's prefill is a `repro_torch.prefill` span while the profiler
runs, and its last-position logits stay on `engine.last_prefill_logits`
(the model's tensor, not a copy) until the next batch.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.coexec import resolve_device
from repro_torch.runtime.spans import span

if TYPE_CHECKING:
    from repro_torch.models.config import ModelConfig
    from repro_torch.runtime.executor import ExecutionReport, PlanExecutor
    from repro_torch.runtime.plan import CoexecPlan


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0           # 0 = greedy
    frames: Optional[np.ndarray] = None  # enc-dec only: (S_enc, D)
    arrival_s: float = 0.0             # admission time (scheduler traffic)


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: List[int]


def sample_tokens(generator: torch.Generator, logits: torch.Tensor,
                  temperatures) -> Tuple[torch.Tensor, torch.Generator]:
    """Per-request sampling shared by the fixed-batch engine and the
    continuous scheduler: row i of `logits` samples at `temperatures[i]`
    (<= 0 = greedy).  Returns (int32 tokens on the logits' device,
    generator).  The generator (on the logits' device) is drawn from only
    when some row actually samples, so all-greedy batches leave it
    untouched.  Sampling is Gumbel-max over `logits / temperature`: the
    reference's categorical distribution, not its random bits."""
    temps = np.asarray(temperatures, np.float32)
    if temps.ndim == 0:
        temps = np.full((logits.shape[0],), temps, np.float32)
    greedy = logits.argmax(-1).to(torch.int32)
    if not bool((temps > 0.0).any()):
        return greedy, generator
    t = torch.from_numpy(temps).to(logits.device)
    hot = t > 0.0
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    safe = torch.where(hot, t, 1.0)
    sampled = (logits.float() / safe[:, None] + gumbel).argmax(-1)
    return torch.where(hot, sampled.to(torch.int32), greedy), generator


class ServingEngine:
    def __init__(self, cfg: "ModelConfig", model, params, *,
                 max_batch: int = 4, max_len: int = 128, seed: int = 0,
                 coexec_plan: Optional["CoexecPlan"] = None,
                 compiled=None, measurement_store=None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if compiled is not None and coexec_plan is not None:
            raise ValueError("pass either compiled= (a repro_torch."
                             "CompiledNetwork) or coexec_plan= (a bare "
                             "CoexecPlan), not both")
        if compiled is not None:
            if not (hasattr(compiled, "plan") and hasattr(compiled, "target")
                    and hasattr(compiled, "executor")):
                raise TypeError("compiled must be a repro_torch."
                                "CompiledNetwork (got "
                                f"{type(compiled).__name__})")
            coexec_plan = compiled.plan
        elif coexec_plan is not None and \
                not hasattr(coexec_plan, "provenance"):
            raise TypeError("coexec_plan must be a repro_torch.runtime "
                            f"CoexecPlan (got {type(coexec_plan).__name__})")
        self.compiled = compiled
        self.coexec_plan = coexec_plan
        if measurement_store is not None and \
                not hasattr(measurement_store, "append"):
            from repro_torch.measure import MeasurementStore
            measurement_store = MeasurementStore(measurement_store)
        self.measurement_store = measurement_store
        self._fidelity_log: List[float] = []   # mean log(wall/pred) per run
        self._plan_executor: Optional["PlanExecutor"] = None
        self.last_execution_report: Optional["ExecutionReport"] = None
        self.last_batch_decode_steps = 0       # decode calls of last batch
        self.last_prefill_logits: Optional[torch.Tensor] = None

    @property
    def plan_executor(self) -> "PlanExecutor":
        """The runtime lowering of the shipped plan on the engine's device
        (built on first use; the CompiledNetwork's memoized executor when
        one was passed)."""
        if self.coexec_plan is None:
            raise ValueError("engine was constructed without a compiled "
                             "network or coexec_plan")
        if self._plan_executor is None:
            if self.compiled is not None:
                self._plan_executor = self.compiled.executor(
                    device=self.device)
            else:
                from repro_torch.runtime.executor import PlanExecutor
                self._plan_executor = PlanExecutor(self.coexec_plan,
                                                   device=self.device)
        return self._plan_executor

    def execute_plan(self, x=None, *, chain: bool = True,
                     warmup: bool = True) -> Tuple[torch.Tensor, Any]:
        """Execute the shipped plan on the co-execution groups of the
        engine's device; returns (output, report).

        Records the executed-vs-predicted fidelity report on
        `self.last_execution_report` (and appends its records to the
        `measurement_store`, when the engine has one).  `warmup=True`
        costs one untimed pass before the executor's first run only, so
        the recorded walls measure steady-state execution, not kernel
        builds."""
        y, report = self.plan_executor.run(x, chain=chain, warmup=warmup)
        self.last_execution_report = report
        ratio = report.mean_log_ratio()
        if ratio is not None:
            self._fidelity_log.append(ratio)
        if self.measurement_store is not None:
            self.measurement_store.append(report)
        return y, report

    @property
    def drift(self) -> Optional[float]:
        """Windowed fidelity drift of the shipped plan: trailing-window
        median of the mean log(wall/pred) fidelity log minus its
        baseline-window median (0.0 = stable, positive = the plan got
        slower than planned).  None until two executions were observed."""
        from repro_torch.measure.drift import windowed_drift
        return windowed_drift(self._fidelity_log)

    @property
    def drift_latest_vs_first(self) -> Optional[float]:
        """The raw two-point comparison: latest run minus first run."""
        if len(self._fidelity_log) < 2:
            return None
        return self._fidelity_log[-1] - self._fidelity_log[0]

    def _sample(self, logits: torch.Tensor, temperatures) -> torch.Tensor:
        tok, self.generator = sample_tokens(self.generator, logits,
                                            temperatures)
        return tok

    def run(self, requests: List[Request]) -> List[Completion]:
        out: List[Completion] = []
        for i in range(0, len(requests), self.max_batch):
            out.extend(self._run_batch(requests[i:i + self.max_batch]))
        return out

    def _run_batch(self, batch: List[Request]) -> List[Completion]:
        b = len(batch)
        t = max(len(r.prompt) for r in batch)
        toks = np.zeros((b, t), np.int64)
        for i, r in enumerate(batch):
            toks[i, t - len(r.prompt):] = r.prompt     # left-pad
        toks = torch.from_numpy(toks).to(self.device)
        # pad-aware attention masks everything before each row's first real
        # token, so a short prompt padded behind a long one decodes exactly
        # as it would alone (RoPE phases are relative)
        pad = {}
        if getattr(self.model, "pad_aware", False):
            pad["start"] = torch.tensor([t - len(r.prompt) for r in batch],
                                        device=self.device)
        cache = self.model.init_cache(b, self.max_len, device=self.device)
        extra = ()
        if self.cfg.is_encoder_decoder:
            # each request's frames, zeros where a request has none
            extra = (torch.from_numpy(np.stack([
                r.frames if r.frames is not None else
                np.zeros((self.cfg.encoder_seq, self.cfg.d_model),
                         np.float32)
                for r in batch])).to(self.device),)
        with span("repro_torch.prefill"):
            logits, cache = self.model.prefill(self.params, toks, cache,
                                               *extra, **pad)
        self.last_prefill_logits = logits

        max_new = max(r.max_new_tokens for r in batch)
        # per-request temperatures: a greedy request stays greedy even when
        # batched behind a temperature-sampling one
        temps = np.array([r.temperature for r in batch], np.float32)
        generated: List[List[int]] = [[] for _ in range(b)]
        tok = self._sample(logits, temps)
        for i, v in enumerate(tok.tolist()):
            generated[i].append(v)
        self.last_batch_decode_steps = 0
        for step in range(1, max_new):
            if all(len(g) >= r.max_new_tokens
                   for g, r in zip(generated, batch)):
                break                   # every request already done
            logits, cache = self.model.decode_step(
                self.params, tok[:, None], cache, t + step - 1, **pad)
            self.last_batch_decode_steps += 1
            tok = self._sample(logits, temps)
            for i, v in enumerate(tok.tolist()):
                if len(generated[i]) < batch[i].max_new_tokens:
                    generated[i].append(v)
        return [Completion(r.rid, g) for r, g in zip(batch, generated)]
