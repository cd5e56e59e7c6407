"""The device time of the interface fluxes and the sea ice
(``step/interface_fluxes`` plus ``step/seaice``) a replayed step, by the
port's tracer: the spans' device stamps over the stamped calls of the timed
path (``stamped.phase``) over their replayed steps, the launch gaps between
their ~500 small kernels inside the graph included."""


def read(ctx):
    stamps = getattr(ctx, "stamps", None)
    if not stamps or "step/interface_fluxes" not in stamps["spans"]:
        return None
    spans = stamps["spans"]
    seaice = spans["step/seaice"]["total_ms"] if "step/seaice" in spans else 0.0
    return (spans["step/interface_fluxes"]["total_ms"] + seaice) / stamps["steps"]
