"""The ``simulation`` driver: the production run script's own ``build`` and
``simulation`` (``Simulation.run`` over the coupled loop, chunks replayed
on the card, the progress callback at every chunk and the surface writer),
run for a window of wall time."""

from __future__ import annotations

import dataclasses
import importlib
import logging
import shutil
import tempfile
import time

from benchmark.drivers import last_call, synchronize, velocity_noise
from benchmark.reference.model import fields_of


class Run:
    def __init__(self, config, workload, seed, device, control=None):
        self.config, self.workload, self.seed = config, workload, seed
        self.device, self.control = device, control
        self.inner = workload["inner_steps"]
        self._timing = None

    def setup(self):
        from gb25_tpu_torch.models import device_loop
        from gb25_tpu_torch.simulation import IterationInterval

        c, prog = self.config, self.config["program"]
        ocs = importlib.import_module(prog["script"])
        self.phases = [("port", time.perf_counter())]
        logging.basicConfig(level=logging.INFO, format="%(message)s")
        self.outdir = tempfile.mkdtemp(prefix="benchmark_surface_")
        args = ocs.parse_args([*prog["argv"], "--device", self.device,
                               "--stop-days", str(c["stop_days"]), "--output-dir", self.outdir])
        ccfg, grid, state, ice, atmos, restoring = ocs.build(args)
        self.phases.append(("model", time.perf_counter()))
        if self.control is not None:
            ccfg = dataclasses.replace(
                ccfg, ocean=dataclasses.replace(ccfg.ocean, compute_dtype=self.control))
        if tuple(grid.shape) != (c["Nz"], c["Ny"], c["Nx"]):
            raise ValueError(f"the program's grid {tuple(grid.shape)} is not the configuration's")
        u, v = velocity_noise(grid.shape, self.seed, c["noise_velocity"], self.device)
        state = state.replace(u=u.to(grid.dtype), v=v.to(grid.dtype))
        sim, self.writer, self.holder = ocs.simulation(args, ccfg, grid, state, ice, atmos,
                                                       restoring)
        sim.add_callback(self._boundary, IterationInterval(self.inner))
        self.sim, self.netcdf = sim, args.output_format == "netcdf"
        self.step_args = (ccfg, grid, atmos, restoring, args.dt)
        device_loop.STATS.reset()
        sim.stop_iteration = 1  # the Euler step, eager, after the initial record
        sim.run()
        self.euler = {k: t.to("cpu", copy=True) for k, t in self._fields().items()}
        self.phases.append(("euler", time.perf_counter()))
        # the rest of the first chunk, eager; the chunk that captures the
        # lead graph; the chunk that captures the full one
        sim.stop_iteration = 3 * self.inner
        sim.run()
        synchronize(self.device)
        self.phases.append(("capture", time.perf_counter()))
        self.pool_bytes = device_loop.STATS.pool_bytes

    def _fields(self):
        return {**fields_of(self.sim.state, "ocean/"), **fields_of(self.holder["ice"], "ice/")}

    def _boundary(self, sim):
        """At each chunk boundary of the window: make the next chunk the
        last where it would end past the window, and copy its input."""
        t = self._timing
        if t is None or t["last"]:
            return
        synchronize(self.device)
        t["chunks"] += 1
        if last_call(time.perf_counter() - t["t0"], t["chunks"], t["seconds"]):
            self.peak = t["peak"]()
            self.snapshot = {k: x.clone() for k, x in self._fields().items()}
            self.snapshot_iteration = sim.iteration
            self.last_steps = self.inner
            sim.stop_iteration = sim.iteration + self.inner
            t["last"] = True

    def window(self, seconds, peak):
        from gb25_tpu_torch.models import device_loop

        device_loop.STATS.reset()
        start = self.sim.iteration
        self.sim.stop_iteration = None
        synchronize(self.device)
        self._timing = {"t0": time.perf_counter(), "seconds": seconds, "chunks": 0,
                        "last": False, "peak": peak}
        self.sim.run()
        synchronize(self.device)
        elapsed = time.perf_counter() - self._timing["t0"]
        self._timing = None
        s = device_loop.STATS
        self.stats = {"replayed": s.replayed_steps, "eager": s.eager_steps,
                      "pool_bytes": self.pool_bytes}
        self.final = self._fields()
        return self.sim.iteration - start, elapsed

    def output(self):
        return self.final

    def profile(self, n):
        start = self.sim.iteration
        self.sim.stop_iteration = start + n * self.inner
        self.sim.run()
        return self.sim.iteration - start

    def host_steps(self, n):
        from gb25_tpu_torch.models.coupled import coupled_ice_time_step

        ccfg, grid, atmos, restoring, dt = self.step_args
        state, ice = self.sim.state, self.holder["ice"]
        for _ in range(n):
            state, ice = coupled_ice_time_step(ccfg, grid, atmos, state, ice, dt,
                                               restoring=restoring, premasked=True)
        self.sim.state, self.holder["ice"] = state, ice
        return n

    def free(self):
        if self.netcdf:
            self.writer.close()
        shutil.rmtree(self.outdir, ignore_errors=True)
        self.__dict__.clear()
