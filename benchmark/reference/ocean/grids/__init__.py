from benchmark.reference.ocean.grids.latlon import (  # noqa: F401
    LatitudeLongitudeGrid,
    latitude_longitude_grid,
    resolution_to_points,
    simple_latitude_longitude_grid,
)
from benchmark.reference.ocean.grids.tripolar import TripolarGrid, tripolar_grid  # noqa: F401
from benchmark.reference.ocean.grids.vertical import exponential_z_faces, uniform_z_faces  # noqa: F401
