"""Profiling and tracing (port of ``self_forcing_tpu/utils/profiling.py``;
the reference's CUDA-event phase timers).

:class:`PhaseTimer` is the port's one synchronising clock: named phases
timed on the host clock, each ended by a synchronise of the CUDA devices
its tensors live on (none on the CPU), so that a phase measures the work
and not its enqueue.  It keeps the reference's breakdown (``report``)
and, for the pipelines' ``profile=True``, consecutive laps
(:meth:`PhaseTimer.lap`, :meth:`PhaseTimer.lap_report`).  :func:`trace`
wraps ``torch.profiler`` (CPU and CUDA activities) and writes a Chrome
trace under its directory."""
from __future__ import annotations

import contextlib
import os
import time

import torch


def synchronize(*targets) -> None:
    """Wait for the CUDA devices of ``targets`` (tensors, devices, or
    nested lists / tuples / dicts of them); nothing for the CPU."""
    seen = set()

    def walk(t):
        if isinstance(t, torch.Tensor):
            t = t.device
        if isinstance(t, torch.device):
            if t.type == "cuda" and t not in seen:
                seen.add(t)
                torch.cuda.synchronize(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    walk(targets)


class PhaseTimer:
    """Accumulates named phase durations (seconds) and block times;
    prints the reference's breakdown.  ``device`` (and ``on``) serve the
    laps: :meth:`lap` ends a phase at a synchronise of ``device``, and
    does nothing when ``on`` is False."""

    def __init__(self, device: str | torch.device | None = None,
                 on: bool = True):
        self.phases: dict[str, float] = {}
        self.block_times: list[float] = []
        self.device = None if device is None else torch.device(device)
        self.on = on
        self._t = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, *sync_targets):
        """``with timer.phase('decode') as ph: out = f(); ph.sync(out)``:
        tensors made inside the body are registered with ``ph.sync()``
        (the entry's ``sync_targets`` can only name ones that exist);
        the phase ends when their devices are synchronised."""
        class _Phase:
            def __init__(self):
                self.targets = list(sync_targets)

            def sync(self, *tensors):
                self.targets.extend(tensors)

        ph = _Phase()
        t0 = time.perf_counter()
        yield ph
        synchronize(ph.targets)
        self.phases[name] = self.phases.get(name, 0.0) + (
            time.perf_counter() - t0)

    def lap(self, name: str) -> None:
        """The time since the last lap (or the timer's start) as phase
        ``name``, ended by a synchronise of the timer's device."""
        if not self.on:
            return
        synchronize(self.device)
        now = time.perf_counter()
        self.phases[name] = self.phases.get(name, 0.0) + (now - self._t)
        self._t = now

    def add_block_time(self, seconds: float) -> None:
        self.block_times.append(seconds)

    def report(self) -> str:
        lines = ["Profiling results:"]
        for name, sec in self.phases.items():
            lines.append(f"  - {name}: {sec * 1e3:.2f} ms")
        if self.block_times:
            for i, b in enumerate(self.block_times):
                lines.append(f"  - Block {i} generation: {b * 1e3:.2f} ms")
            avg = sum(self.block_times) / len(self.block_times)
            lines.append(f"  - Average block time: {avg * 1e3:.2f} ms")
        total = sum(self.phases.values())
        lines.append(f"  - Total time: {total * 1e3:.2f} ms")
        return "\n".join(lines)

    def lap_report(self) -> dict:
        """The laps in ms with their sum under "total_ms", printed on one
        line (the pipelines' ``profile=True`` output)."""
        ms = {k: v * 1e3 for k, v in self.phases.items()}
        ms["total_ms"] = sum(ms.values())
        print("Profiling results: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ms.items()), flush=True)
        return ms


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the body (CPU activities, and CUDA where
    there is a card), its Chrome trace written to
    ``<logdir>/trace_<pid>.json`` at the end."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
