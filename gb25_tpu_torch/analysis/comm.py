"""The halo exchange's traffic and the weak-scaling projection (the
arithmetic of the JAX package's ``analysis/comm.py``).

The JAX package reads its counts from the compiled program's HLO (the
collective permutes of the steady-state loop body). The port counts what
its tiles post (``parallel.halo.MeshComm.traffic``): the exchanges
(batches of point-to-point messages, each one latency round) and the bytes
this rank sends, over one step launched from the host
(``step_traffic``). ``project_weak_scaling`` takes the link rate and the
per-exchange latency as arguments: the port carries no interconnect
constants of its own.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class CommStats:
    permute_count: int          # exchanges per step (latency rounds)
    bytes_per_step: int         # bytes sent per rank per step


def step_traffic(fn, state, dt) -> CommStats:
    """This rank's exchanges and bytes sent over one step of the tile
    function ``fn`` (``parallel.sharded_step_fn``'s) from ``state``,
    launched from the host; zero on the serial route (no exchange)."""
    comm = fn.comm
    if comm is None:
        return CommStats(0, 0)
    comm.traffic.reset()
    fn.step(state, dt=dt)
    return CommStats(comm.traffic.exchanges, comm.traffic.bytes_sent)


def project_weak_scaling(ms_per_step_compute: float, stats: CommStats, *,
                         bytes_per_sec: float, latency_per_exchange: float,
                         chip_counts=(8, 16, 32, 64, 128, 256), overlap: bool = True,
                         uncertainty: float = 2.0):
    """Weak-scaling efficiency at a fixed tile a rank, whose bytes and
    exchanges per step do not change with the count: the comm term
    ``bytes / bytes_per_sec + exchanges * latency_per_exchange`` hides
    under the compute (``overlap``) or adds to it. Returns {count:
    {ms_per_step, efficiency, comm_ms, comm_ms_range, efficiency_range}},
    the ranges spanning the comm term from nominal to ``uncertainty``
    times nominal."""
    t_comp = ms_per_step_compute / 1e3
    t_comm = stats.bytes_per_step / bytes_per_sec + stats.permute_count * latency_per_exchange
    t_comm_hi = t_comm * uncertainty
    out = {}
    for n in chip_counts:
        def total(tc):
            return max(t_comp, tc) if overlap else t_comp + tc

        t, t_hi = total(t_comm), total(t_comm_hi)
        out[n] = {
            "ms_per_step": 1e3 * t,
            "efficiency": t_comp / t,
            "comm_ms": 1e3 * t_comm,
            "comm_ms_range": [1e3 * t_comm, 1e3 * t_comm_hi],
            "efficiency_range": [t_comp / t_hi, t_comp / t],
        }
    return out
