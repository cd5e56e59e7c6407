"""The device busy time of the interface fluxes and the sea ice
(``step/interface_fluxes`` plus ``step/seaice``) a step: the union of the
kernels inside each range in steps launched from the host, so that the
device's waits on the host's launches inside the range do not count."""


def read(ctx):
    if "step/interface_fluxes" not in ctx.spans:
        return None
    return ctx.spans["step/interface_fluxes"] + ctx.spans.get("step/seaice", 0.0)
