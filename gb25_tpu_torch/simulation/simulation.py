"""The simulation driver (port of ``gb25_tpu.simulation.simulation``):
schedules, callbacks, output writers, checkpoints and progress, the
reference's Simulation(model; dt, stop_time) with
add_callback!(progress, IterationInterval(10)) and a surface writer.

The driver advances in chunks of at most ``inner_steps`` steps, each one
call of the step function (a loop on the device), and returns to Python
only at the chunk boundaries, which it shrinks to land on every schedule
(callbacks, writers' intervals, the stop time). The default step function
is ``models.hydrostatic.loop`` with ``chunk=inner_steps``: on the card every
full chunk replays from a CUDA graph of its length (the first, which
starts with the eager Euler step, from one of ``inner_steps - 1``), and
only chunks cut short by a schedule run from the host
(``models.device_loop``). A custom ``step_fn(cfg, grid, state, dt, n)``
should pass ``chunk`` to its loop the same way.

``run`` spans its parts (``utils.tracing``): ``sim/chunk`` the step
function's call, ``sim/schedule`` the stop test and the chunk's length
(which read the device clock ``state.time`` on the host) and the writers'
schedules, ``sim/callbacks`` the callbacks, ``sim/writers`` the writers.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil
import time as _time
from typing import Callable

import numpy as np
import torch

from gb25_tpu_torch.utils.tracing import span

logger = logging.getLogger("gb25_tpu_torch")


@dataclasses.dataclass
class IterationInterval:
    every: int

    def aligned_steps(self, sim, max_steps: int) -> int:
        k = self.every - (sim.iteration % self.every)
        return min(k, max_steps)

    def should_fire(self, sim) -> bool:
        return sim.iteration % self.every == 0


@dataclasses.dataclass
class TimeInterval:
    """A schedule on model time: the driver shrinks chunks so that the time
    lands on each multiple of ``seconds`` (the reference's TimeInterval
    alignment)."""

    seconds: float

    def __post_init__(self):
        self._next = None

    def _init(self, time: float):
        if self._next is None:
            self._next = (np.floor(time / self.seconds + 1e-12) + 1) * self.seconds

    def aligned_steps(self, sim, max_steps: int) -> int:
        self._init(sim.time)
        k = int(np.ceil((self._next - sim.time) / sim.dt - 1e-9))
        return min(max(k, 1), max_steps)

    def should_fire(self, sim) -> bool:
        self._init(sim.time)
        if sim.time >= self._next - 1e-6:
            while self._next <= sim.time + 1e-6:
                self._next += self.seconds
            return True
        return False


@dataclasses.dataclass
class Callback:
    fn: Callable  # fn(sim) -> None
    schedule: object


class Simulation:
    """Drives a model through its step function in chunks (the
    reference's Simulation). ``comm``: the tile's exchange on the
    decomposed path (the default loop gets it; a ``CheckpointWriter``
    writes the tile with its global slices)."""

    def __init__(self, cfg, grid, state, dt, stop_time=None, stop_iteration=None,
                 inner_steps=16, comm=None, step_fn=None, wall_time_limit=None):
        self.cfg = cfg
        self.grid = grid
        self.state = state
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.wall_time_limit = wall_time_limit  # seconds
        self.inner_steps = inner_steps
        self.callbacks: list[Callback] = []
        self.output_writers: list = []
        self._writer_schedules: list[TimeInterval] = []
        if step_fn is None:
            from gb25_tpu_torch.models.hydrostatic import loop

            def step_fn(cfg, grid, state, dt, n):
                return loop(cfg, grid, state, dt, n, comm=comm, chunk=inner_steps)

        self._step_fn = step_fn
        self._comm = comm
        self.mesh = comm.mesh if comm is not None else None
        self.run_wall_time = 0.0

    def add_callback(self, fn, schedule):
        self.callbacks.append(Callback(fn, schedule))

    def add_output_writer(self, writer):
        self.output_writers.append(writer)
        # chunk boundaries land on the writer's interval, so its records do
        iv = getattr(writer, "interval", None)
        if iv:
            self._writer_schedules.append(TimeInterval(iv))

    @property
    def iteration(self) -> int:
        return int(self.state.iteration)

    @property
    def time(self) -> float:
        return float(self.state.time)

    def _next_chunk(self) -> int:
        n = self.inner_steps
        if self.stop_iteration is not None:
            n = min(n, self.stop_iteration - self.iteration)
        if self.stop_time is not None:
            n = min(n, int(np.ceil((self.stop_time - self.time) / self.dt - 1e-9)))
        for sched in [cb.schedule for cb in self.callbacks] + self._writer_schedules:
            n = min(n, sched.aligned_steps(self, n))
        return max(n, 0)

    def _should_stop(self) -> bool:
        if self.stop_iteration is not None and self.iteration >= self.stop_iteration:
            return True
        if self.stop_time is not None and self.time >= self.stop_time - 1e-9:
            return True
        return False

    def run(self):
        """Run to the stop time or iteration (or the wall-time limit):
        the initial records, then chunk after chunk, the callbacks and
        writers after each."""
        t0 = _time.perf_counter()
        # the initial record at the true start time
        with span("sim/writers"):
            for w in self.output_writers:
                w.maybe_write(self)
        while True:
            with span("sim/schedule"):
                if self._should_stop():
                    break
                if (self.wall_time_limit is not None
                        and _time.perf_counter() - t0 > self.wall_time_limit):
                    logger.warning("wall-time limit reached; stopping cleanly")
                    break
                n = self._next_chunk()
                if n <= 0:
                    break
            with span("sim/chunk"):
                self.state = self._step_fn(self.cfg, self.grid, self.state, self.dt, n)
            with span("sim/callbacks"):
                for cb in self.callbacks:
                    if cb.schedule.should_fire(self):
                        cb.fn(self)
            with span("sim/schedule"):
                for sched in self._writer_schedules:
                    sched.should_fire(self)  # keeps the boundary tracking advancing
            with span("sim/writers"):
                for w in self.output_writers:
                    w.maybe_write(self)
        self.run_wall_time = _time.perf_counter() - t0
        return self.state


class CheckpointWriter:
    """Periodic sharded checkpoints (``io.checkpoint``) into
    ``directory/ckpt_iter<It>``, on a schedule of model time, keeping the
    last ``keep``; on the decomposed path each rank writes its tile."""

    def __init__(self, directory, interval_seconds=86400.0, keep=2):
        self.directory = directory
        self.interval = interval_seconds
        self.keep = keep
        self._last = None
        self._written = []
        self.write_seconds = []  # wall time of each write

    def maybe_write(self, sim):
        from gb25_tpu_torch.io.checkpoint import save_sharded_state
        from gb25_tpu_torch.io.output import _boundary_crossed

        fire, self._last = _boundary_crossed(sim.time, self.interval, self._last)
        if not fire:
            return
        t0 = _time.perf_counter()
        path = os.path.join(self.directory, f"ckpt_iter{sim.iteration:09d}")
        mesh = getattr(sim, "mesh", None)
        save_sharded_state(sim.state, path, mesh=mesh)
        self.write_seconds.append(_time.perf_counter() - t0)
        self._written.append(path)
        while len(self._written) > self.keep:
            old = self._written.pop(0)
            if mesh is None or mesh.rank == 0:
                shutil.rmtree(old, ignore_errors=True)


def progress_callback(sim: Simulation):
    """Log the iteration, time, max|u| and the range of T (the reference's
    progress message). The reductions run on the device; three scalars
    cross to the host."""
    s = sim.state
    T = s.tracers.get("T")
    stats = [s.u.abs().max()] + ([T.min(), T.max()] if T is not None else [])
    stats = torch.stack(stats).tolist()
    msg = f"iter={sim.iteration} t={sim.time / 86400.0:.3f} days max|u|={stats[0]:.4f}"
    if T is not None:
        msg += f" T in [{stats[1]:.3f}, {stats[2]:.3f}]"
    logger.info(msg)
