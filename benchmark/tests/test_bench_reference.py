"""The plain reference (``benchmark/reference``) against the port's plain
path on small grids, in float64, for each configuration's physics and
route: the reference's own initial state equals the port's, and three
steps from the same state (the reference's, with the benchmark's
velocities) equal bit for bit."""

import dataclasses

import pytest
import torch

from benchmark import spec
from benchmark.drivers import velocity_noise
from benchmark.reference.model import fields_of, with_fields
from small import small_cell

F64 = torch.float64


def port_flagship(config, route):
    from gb25_tpu_torch.models import baroclinic_instability_model, time_step

    cfg, grid, state = baroclinic_instability_model(*config["program"]["args"], device="cpu",
                                                    dtype=F64, kernels=route)
    state = state.replace(u=torch.zeros_like(state.u), v=torch.zeros_like(state.v))
    return state, lambda s: time_step(cfg, grid, s, config["dt"])


def port_climate(config, route):
    from gb25_tpu_torch.models.coupled import OceanIceState, coupled_ice_time_step
    from gb25_tpu_torch.scripts import ocean_climate_simulation as ocs

    args = ocs.parse_args([*config["program"]["argv"], "--device", "cpu", "--float-type", "f64"])
    ccfg, grid, state, ice, atmos, restoring = ocs.build(args)
    ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, kernels=route))

    def step(s):
        return OceanIceState(*coupled_ice_time_step(ccfg, grid, atmos, s.ocean, s.ice,
                                                    config["dt"], restoring=restoring))

    return OceanIceState(state, ice), step


PORT = {"bi_flagship": port_flagship, "ocean_climate_q": port_climate}


@pytest.mark.parametrize("cell, route", [("bi_flagship.loop", "auto"),
                                         ("bi_flagship.k6", "pallas"),
                                         ("ocean_climate_q.sim", "auto")])
def test_reference_equals_the_port_plain_path(cell, route):
    c = small_cell(cell).config
    model = spec.reference(c["name"]).build(c, route, "cpu", F64)
    port, step = PORT[c["name"]](c, route)
    start = fields_of(port)
    for k, t in fields_of(model.initial).items():
        assert torch.equal(t, start[k]), k
    u, v = velocity_noise((c["Nz"], c["Ny"], c["Nx"]), 5, c["noise_velocity"], "cpu")
    ref = model.with_velocity(u.double(), v.double())
    port = with_fields(port, fields_of(ref), 0)
    for _ in range(3):
        ref = model.advance(ref)
        port = step(port)
    got, want = fields_of(port), model.fields(ref)
    for k in model.prognostic:
        assert torch.equal(got[k], want[k]), k
