"""The drivers that run the port's system under test, one module a kind of
run (``workloads/<cell>.json`` names it under "driver"). Each defines
``Run(config, workload, seed, device, control=None)`` with:

  - ``setup()``: build the program from the configuration, hand it the
    benchmark's initial velocities, take its first (Euler) step, keep a
    host copy of that state (``euler``), and warm and capture everything the
    window replays; ``phases`` holds (name, ``time.perf_counter()``) at
    the end of each of its phases;
  - ``window(seconds, peak)``: run the timed path until ``seconds`` have
    passed, copy the input of the window's last call (``snapshot``, at
    ``snapshot_iteration``, its ``last_steps`` steps ahead) after reading
    ``peak()`` (the run's peak memory, before the copy); returns (steps,
    wall seconds), the card synchronized at both ends;
  - ``output()``: the state the window left, its tensors by name;
  - ``profile(n)``: ``n`` more calls of the timed path (whole graphs);
    returns the steps they ran;
  - ``host_steps(n)``: ``n`` steps of the same step function launched from
    the host; returns ``n``;
  - ``stats``: the device loop's counts of the window (``replayed``,
    ``eager``) and the graph pools' bytes (``pool_bytes``);
  - ``free()``: drop the program, its graphs and its outputs on disk.

``control`` runs the program with that ``compute_dtype`` (the control of
``calibrate.py``): the benchmark's own runs never pass it.
"""

import importlib

import torch


def velocity_noise(shape, seed, amplitude, device):
    """The benchmark's initial velocities: ``amplitude`` times standard
    normal u, then v, from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, in float32; v zero on the southern wall face (row 0)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    u = amplitude * torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    v = amplitude * torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    v[:, 0, :] = 0.0
    return u, v


def resolve(path):
    """The object a dotted path names (a module's attribute)."""
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def last_call(elapsed, calls, seconds):
    """Whether the next call of the timed path is the window's last: after
    at least one call, when one more of the mean length so far reaches
    ``seconds``."""
    return calls > 0 and elapsed + elapsed / calls >= seconds


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
