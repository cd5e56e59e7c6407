"""The closure-free eddy run in the port and in the JAX package on the CPU,
chunk by chunk from one initial state: the witness that tells a fault of
the port from float32 rounding where the 1-degree run goes non-finite
before its 20 days.

The JAX package's validated 1-degree configuration
(docs/EDDY_VALIDATION.json "one_degree": 360x160x8, dt 900 s, chunks of 96
steps, noise 1e-3, seed 42, no closure) runs in both packages from the
same state: JAX's (``--init jax``, carried into the port) or the port's
(``--init port``, drawn on the CPU and carried into JAX), in float32 or
float64. After each chunk it prints one JSON line: the day, each package's
EKE and max|u|, and the EKE's relative difference, for 20 days; a
package whose EKE is not finite stops there, the other runs on.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_eddy_witness.py \\
        --dtype float32 --init jax [--seed 42] [--threads 4]

``--seed`` draws another initial noise (the validated run's is 42), so
that the onset day of a non-finite EKE can be counted over seeds.

The test runs the same code at 48x24x8 for two chunks of 8 steps in
float64 from JAX's state and holds the port's EKE and max|u| to JAX's at
1e-10.
"""

import argparse
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gb25_tpu.grids import simple_latitude_longitude_grid as jax_latlon
from gb25_tpu.models import baroclinic_instability_config as jax_config
from gb25_tpu.models import baroclinic_instability_state as jax_state
from gb25_tpu.models import loop as jax_loop
from gb25_tpu.models.state import HydrostaticState as JaxState
from gb25_tpu.utils.correctness import _leaf_names
from gb25_tpu.utils.diagnostics import eddy_mean_kinetic_energy as jax_eke
from gb25_tpu_torch.convert import state_from_numpy, state_to_numpy
from gb25_tpu_torch.grids import simple_latitude_longitude_grid
from gb25_tpu_torch.models import (
    baroclinic_instability_config,
    baroclinic_instability_state,
    loop,
)
from gb25_tpu_torch.utils.diagnostics import eddy_mean_kinetic_energy


def _jax_state(arrays):
    names = sorted(k.split("/", 1)[1] for k in arrays if k.startswith("tracers/"))

    def a(k):
        return jnp.asarray(arrays[k])

    return JaxState(u=a("u"), v=a("v"), eta=a("eta"),
                    tracers={k: a(f"tracers/{k}") for k in names},
                    Gu=a("Gu"), Gv=a("Gv"), Geta=a("Geta"),
                    Gtracers={k: a(f"Gtracers/{k}") for k in names},
                    time=a("time"), time_lo=a("time_lo"),
                    iteration=jnp.asarray(arrays["iteration"], jnp.int32))


def trajectories(nx, ny, nz, dtype, init, chunks, chunk, dt=900.0, noise=1e-3, seed=42):
    """After each of ``chunks`` chunks of ``chunk`` steps, a dict: the day
    and each package's (EKE, max|u|), the package left out once its EKE has
    gone non-finite."""
    jg = jax_latlon(nx, ny, nz, dtype=jnp.dtype(dtype))
    pg = simple_latitude_longitude_grid(nx, ny, nz, device="cpu", dtype=getattr(torch, dtype))
    cj, cp = jax_config(), baroclinic_instability_config()
    if init == "jax":
        sj = jax_state(jg, noise_velocity=noise, seed=seed, tracers=cj.tracers)
        sp = state_from_numpy({n: np.asarray(x) for n, x in _leaf_names(sj)}, "cpu")
    else:
        sp = baroclinic_instability_state(pg, noise_velocity=noise, seed=seed,
                                          tracers=cp.tracers)
        sj = _jax_state(state_to_numpy(sp))
    lp = jax.jit(jax_loop, static_argnames="n")
    dke = jax.jit(jax_eke)
    dt_j = jnp.asarray(dt, jg.dtype)
    live = {"jax": True, "port": True}
    for i in range(chunks):
        row = {"day": (i + 1) * chunk * dt / 86400.0}
        if live["jax"]:
            sj = lp(cj, jg, sj, dt_j, chunk)
            row["jax"] = (float(dke(jg, sj)[0]), float(jnp.max(jnp.abs(sj.u))))
        if live["port"]:
            sp = loop(cp, pg, sp, dt, chunk)
            row["port"] = (float(eddy_mean_kinetic_energy(pg, sp)[0]),
                           float(sp.u.abs().max()))
        for k in live:
            live[k] = live[k] and math.isfinite(row.get(k, (math.nan,))[0])
        yield row


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors (the other test
    files' reason)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_witness_agrees_in_float64():
    rows = list(trajectories(48, 24, 8, "float64", "jax", chunks=2, chunk=8))
    assert [r["day"] for r in rows] == [8 * 900.0 / 86400.0, 16 * 900.0 / 86400.0]
    for r in rows:
        (ej, uj), (ep, up) = r["jax"], r["port"]
        assert ej > 0 and uj > 0
        assert ep == pytest.approx(ej, rel=1e-10) and up == pytest.approx(uj, rel=1e-10)
    assert rows[1]["jax"][0] != rows[0]["jax"][0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    p.add_argument("--init", default="jax", choices=["jax", "port"])
    p.add_argument("--seed", type=int, default=42, help="the initial noise's seed")
    p.add_argument("--threads", type=int, default=4, help="torch's intra-op threads")
    args = p.parse_args(argv)
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    torch.set_num_threads(args.threads)
    head = {"nx": 360, "ny": 160, "nz": 8, "dt": 900.0, "chunk": 96, "dtype": args.dtype,
            "init": args.init, "seed": args.seed}
    print(json.dumps(head), flush=True)
    for row in trajectories(360, 160, 8, args.dtype, args.init, 20, 96, seed=args.seed):
        ej, ep = row.get("jax", (None,))[0], row.get("port", (None,))[0]
        if ej is not None and ep is not None and math.isfinite(ej) and ej:
            row["eke_rel_diff"] = abs(ep - ej) / ej
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
