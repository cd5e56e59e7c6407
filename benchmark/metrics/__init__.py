"""The readers of the per-layer metrics, one module a metric, named as
``BENCHMARK.json`` names it. Each defines ``read(ctx)``, which returns the
metric's value or None where the run has nothing to read for it. ``ctx``
holds: ``shape`` (``counts.shape.Shape`` of the configuration), ``steps``
and ``wall_s`` (the measured window of the traced run), ``profiled`` (a
``trace.Window`` over whole replayed calls), ``spans`` (each ``step/*``
range's device busy ms a step in steps launched from the host,
``trace.Window.stage_busy_ms``), ``stats`` (the
device loop's counts of the window) and ``workload``, ``config`` (the
files' dicts)."""
