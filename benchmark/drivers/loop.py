"""The ``loop`` driver: the port's ``models.loop`` called again and again
with the same number of steps, each call replayed on the card from the
graph the device loop captured in set-up."""

from __future__ import annotations

import dataclasses
import time

import torch

from benchmark.drivers import last_call, resolve, synchronize, velocity_noise
from benchmark.reference.model import fields_of


class Run:
    def __init__(self, config, workload, seed, device, control=None):
        self.config, self.workload, self.seed = config, workload, seed
        self.device, self.control = device, control
        self.calls = workload["call_steps"]

    def setup(self):
        from gb25_tpu_torch.models import device_loop
        from gb25_tpu_torch.models.hydrostatic import loop

        self.phases = [("port", time.perf_counter())]
        c, prog = self.config, self.config["program"]
        ctor = resolve(prog["constructor"])
        cfg, grid, state = ctor(*prog["args"], device=self.device, halo=tuple(c["halo"]),
                                dtype=getattr(torch, c["dtype"]), kernels=self.workload["route"])
        if self.control is not None:
            cfg = dataclasses.replace(cfg, compute_dtype=self.control)
        if tuple(grid.shape) != (c["Nz"], c["Ny"], c["Nx"]):
            raise ValueError(f"the program's grid {tuple(grid.shape)} is not the configuration's")
        u, v = velocity_noise(grid.shape, self.seed, c["noise_velocity"], self.device)
        state = state.replace(u=u.to(grid.dtype), v=v.to(grid.dtype))
        self.loop, self.cfg, self.grid, self.dt = loop, cfg, grid, c["dt"]
        self.phases.append(("model", time.perf_counter()))
        device_loop.STATS.reset()
        state = loop(cfg, grid, state, self.dt, 1)  # the Euler step, eager
        self.euler = {k: t.to("cpu", copy=True) for k, t in fields_of(state).items()}
        self.phases.append(("euler", time.perf_counter()))
        # a real step that fills every cache, the capture, one replay
        self.state = loop(cfg, grid, state, self.dt, self.calls + 1)
        synchronize(self.device)
        self.phases.append(("capture", time.perf_counter()))
        self.pool_bytes = device_loop.STATS.pool_bytes

    def _call(self):
        self.state = self.loop(self.cfg, self.grid, self.state, self.dt, self.calls)

    def window(self, seconds, peak):
        from gb25_tpu_torch.models import device_loop

        device_loop.STATS.reset()
        synchronize(self.device)
        t0 = time.perf_counter()
        calls = 0
        elapsed = 0.0
        while True:
            last = last_call(elapsed, calls, seconds)
            if last:
                self.peak = peak()
                self.snapshot = {k: t.clone() for k, t in fields_of(self.state).items()}
                self.snapshot_iteration = self.state.iteration
                self.last_steps = self.calls
            self._call()
            synchronize(self.device)
            elapsed = time.perf_counter() - t0
            calls += 1
            if last:
                break
        s = device_loop.STATS
        self.stats = {"replayed": s.replayed_steps, "eager": s.eager_steps,
                      "pool_bytes": self.pool_bytes}
        self.final = self.state
        return calls * self.calls, elapsed

    def output(self):
        return fields_of(self.final)

    def profile(self, n):
        for _ in range(n):
            self._call()
        return n * self.calls

    def host_steps(self, n):
        from gb25_tpu_torch.models.device_loop import host_loop
        from gb25_tpu_torch.models.hydrostatic import loop_step

        self.state = host_loop(loop_step(self.cfg, self.grid, self.dt), self.state, n)
        return n

    def free(self):
        self.__dict__.clear()
