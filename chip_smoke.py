"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``gb25_tpu_torch/csrc`` (one nvcc per
source, all started together) and drives its main paths through the
public entry points, each at 1536x768x64 f32 (halo 4, dt = 60 s, 30
barotropic substeps). Every serial loop (``loop``, ``coupled_loop``,
``sw_loop``) runs as the user runs it: replayed from a captured CUDA graph
of 16 steps (``models.device_loop``). So each main path below also checks
the device loop:
  - launch counts, zeroed just before each main path and read just
    after it: a replay does not pass through the kernels' wrappers, so
    each capture reads the wrappers' counts before and after it (the
    launches it recorded), and a kernel's launches on the device are its
    wrapper's count (eager steps, steps a capture recorded) less what the
    captures recorded plus what the replays made (recorded x replays);
    both are held to launches per step x steps, and the eager and replayed
    steps must make up the run. In the run, a probe of 17 steps (one
    replayed block, one step from the host) runs under the profiler, which
    must see each kernel's launches per step x 17 on the device; were no
    kernel of the replayed block seen (a profiler blind inside graphs) the
    counts would stand alone; a count above that fails the run, and one
    below (the profiler loses records of a busy window) runs the probe
    again, up to 4 times, before it fails the run. The method is printed
    and named in the kernel entries;
  - the device loop against the host loop over 16 steps from the state
    after the timed loop, bit for bit on every field, the clock and the
    iteration (the run fails otherwise or if no graph was replayed), and
    the host loop's ms/step beside the replayed one.
The decomposed rows ([20], [21], [31], [33]) run on the forced 1x1 mesh,
whose exchanges stay on the device, so their loops replay too and are
held the same way.

  1. the card's name and power limit, torch and CUDA versions;
  2. the kernel build (nvcc, sm_90a), its time and each kernel's ptxas
     register and spill counts;
  the flagship baroclinic-instability ocean:
  3. K1 (zslab_tendencies, tracers T, S) against its plain PyTorch version,
     rtol 2e-4: the instance the step runs, which makes b and its column
     totals itself; its time beside its bound, registers, shared memory per
     block, tile and blocks per SM (so for every K1 and K6 instance); the
     instance that reads b (a closure's route) timed beside it, alone and
     with the eager buoyancy before it;
  4. K2 (barotropic_loop: all 30 substeps in one cooperative launch)
     against its plain version at 1536x768, bit for bit (the run fails
     otherwise), in the instance its size takes (the tiles on chip) and in
     its L2 instance; its launch line: registers, shared memory a block,
     blocks per SM, the grid of tiles, cells a tile, the instance;
  5. the main path: one step with kernels="auto" against one with
     kernels="torch" (rtol 1e-3; atol 1e-3 of each field's largest value,
     at most 5e-6), then 8 warm-up steps and two 64-step loops, the
     second one timed; the launch counts must show one K1 launch and one
     K2 launch per step, and the fields must stay finite;
  6. a few steps of the plain path, timed;
  the coupled climate model (Gaussian islands, CATKE, air-sea fluxes) at
  resolution 1/4 degree:
  7. K4 (catke_diffusivities) against its plain version, all five outputs,
     rtol 1e-6;
  8. K3 (implicit_diffusion) against its plain version: the u, v pair, the
     T, S pair and e with its decay rate, bit for bit (the run fails
     otherwise); each solve's registers, shared memory, columns a block,
     blocks per SM and levels in flight;
  9. K1 in its climate instance (tracers T, S, e and the immersed u*, v*
     integrals), rtol 2e-4, and K2 with the solid-face masks, bit for bit,
     as in [4];
  10. the main path: 8 coupled steps from rest, then from there one step
     with kernels="auto" against one with kernels="torch" (tolerances of
     [5]); then 8 warm-up steps and two 32-step loops, the second one
     timed; the launch counts must show per
     step exactly 1 K1, 1 K2, 3 K3 and 1 K4 launch; then the fields must
     be finite with 0 < max|u| < 10 m/s, e >= 0, u and v 0 on the faces of
     land columns and eta 0 on land columns;
  11. a few coupled steps of the plain path, timed;
  the coupled climate model on the tripolar grid (the reference benchmark's
  grid: the islands on its two north poles, the north fold):
  12. K1 in its tripolar instance (the metrics and f as 2-D planes), rtol
     2e-4, and K2's fold instance (masks, the fold's ghost flux above the
     seam row, 2-D planes), bit for bit, as in [4];
  13. the main path as [10]: 8 coupled steps, one step kernels vs plain,
     8 warm-up steps and two 32-step loops, launch counts per step exactly
     1 K1, 1 K2, 3 K3, 1 K4; finite fields, land at rest;
  14. 3 coupled steps of the plain path, timed;
  the flagship with the k-epsilon closure (tracers T, S, e, eps, from
  e = 1e-5, eps = 1e-8):
  15. K4's k-epsilon function against its plain version, bit for bit;
  16. K1 in its four-tracer instance, rtol 2e-4;
  17. K3's four solves of a k-epsilon step (u, v; T, S; e; eps, neither
     damped), bit for bit as in [8];
  18. the main path: one step kernels vs plain (tolerances of [5]), 8
     warm-up steps and two 32-step loops, launch counts per step exactly
     1 K1, 1 K2, 4 K3, 1 k-epsilon K4 and no CATKE K4; then finite
     fields, e >= 0 and eps >= 0; 3 steps of the plain path, timed;
  the decomposed path, forced onto a 1x1 mesh (the bench's decomposed 1x1
  rows, exchange_width = 30: one block of 30 substeps a step):
  19. K5 (barotropic_block) against its plain version on one block at the
     decomposed climate shape, (768 + 60) x (1536 + 60) planes, with
     tripolar metric planes and masks and with lat-lon metric columns, bit
     for bit on the whole extended planes (the run fails otherwise), in
     exactly ceil(30 / s) launches (s: the kernel's substeps a launch);
     its registers, shared memory, tile, blocks per SM and s; its time by
     the wrapper's calls and, queued behind a sleeping kernel, the device's
     alone;
  20. the tripolar climate model: 8 steps, then one step kernels vs plain
     (tolerances of [5]), one step "ring" against "local" bit for bit,
     then in each mode 8 warm-up steps and two 32-step loops, the second
     timed, replayed through one ``sharded_coupled_step_fn`` (its tile
     grid keeps the graph), launch counts per step exactly 1 K1,
     ceil(30 / s) K5, 0 K2, 3 K3, 1 K4 with the profiler probe, the device
     loop against the host loop bit for bit over 16 steps and the host
     loop's ms/step beside the replayed one; finite fields, land at rest;
     ms/step beside [13]'s;
  21. the flagship the same way: per step 1 K1, ceil(30 / s) K5, 0 K2;
     beside [5]'s.
  "ring" runs on an NCCL process group of one rank (a ``HashStore``, no
  network); its exchanges are copies of the tile's own strips, "local"
  fills the ghosts from the boundary conditions. While "ring" runs, every
  torch.distributed exchange and collective raises: its replayed loop
  must call none (``parallel.mesh.post`` also refuses one under a
  capture).
  the K6 route (kernels="pallas": the one-pass tendency kernel with TEOS-10
  inside, the unfused AB2 update, the blocked free surface serially, W = 4):
  22. K6 (pallas_tendencies) against its plain version, rtol 2e-4, in its
     flagship instance (tracers T, S), its tripolar instance (T, S, e, 2-D
     metric planes) on the climate operands of [12] and its four-tracer
     instance on the k-epsilon operands of [16]: the one launch and the
     split pair (momentum, then tracers), each bit for bit with the plain
     version, and the kernel's TEOS-10 buoyancy bit for bit too; then
     the k-epsilon flagship on the K6 route, 8 + 2x32 steps, per step
     exactly 1 K6, 4 K3, 1 k-epsilon K4, 0 K1, 0 K2 and K5's ceil(n / s)
     launches for each block of n substeps (seven blocks of 4, one of 2);
  23. the flagship on the K6 route: one step kernels="pallas" against one
     step kernels="torch" (tolerances of [5], but u, v and eta at an atol
     of 1e-3 of their largest value and Gu, Gv on fluid faces at 8 ulps of
     p over the face's spacing where that is larger: float32 rounding, see
     ``route_step_compare``; u, v, eta, Gu and Gv of both beside the
     "torch" step in float64), then 8 warm-up steps and two 64-step loops,
     the second one timed; per step exactly 1 K6, 0 K1, 0 K2 and K5's
     launches of [22]; finite fields; ms/step beside [5]'s; then K5
     against its plain version, bit for bit and in ceil(n / s) launches,
     on the operands of one more step's first block (4 substeps) and last
     block (2), both timed;
  24. the tripolar climate on the K6 route: 8 coupled steps, one step
     against "torch" and float64 (as in [23]), 8 warm-up steps and two
     32-step loops, the second timed; per step exactly 1 K6, 3 K3, 1 K4, 0
     K1, 0 K2 and K5's launches of [22]; finite fields, land at rest;
     ms/step beside [13]'s;
     K5 on one more step's first and last blocks (metric planes, masks);
  the shallow-water model of bench.py --config atmosphere at 1536x768:
  25. 8 steps, then one step on the card against the same step on the CPU
     in float64 (tolerances of ``sw_step_vs_f64``: float32 rounding of the
     Bernoulli potential and of the mass flux over a face); 8 warm-up
     steps and two 64-step loops, the second timed, replayed; finite
     fields, max|u| between 0.01 and 10 m/s (the geostrophic jet), the
     mass sum(h azc) kept to float32 rounding; the device loop against the
     host loop bit for bit; the same 8 + 64 + 64 steps launched from the
     host, timed.
  the serial flagship's further run-script choices (the JAX package's
  utils/args.py), each phase's wall time printed:
  26. K1's unfused instances (no AB2 update, no integrals) on the
     flagship's fields after 8 steps: the float32 one and the bf16-storage
     one (u, v, the tracers and b read as bfloat16, float32 arithmetic),
     each against its plain version at rtol 2e-4, the bf16 one on operands
     rounded beforehand bit for bit with itself on the raw ones and apart
     from the float32 one; each timed beside its bound and launch line;
  27. the precision modes: "bf16s" (K1's bf16-storage instance and K2,
     8 + 2x32 steps), "bfloat16" (the cast array path and K2, 8 + 2x32)
     and "f32x2" (the float64 array path and K2, at 768x384x64, 8 + 2x32):
     held to float32 by the JAX package's own test of the mode at its size
     (bf16s, f32x2: one step at 32x16x8, every field pointwise within 0.5
     and in RMS within 0.05 of its largest value; bfloat16: 10 steps at
     32x16x6, u within 0.15 of max|u|, T within 0.3); at the row's size one
     step from rest against the float32 step, finite, its distances
     printed; one step after 8 against the mode's "torch" step (the
     tolerances of [5]),
     then the main path (bf16s: per step 1 K1, 1 K2, the profiler probe and
     the device loop against the host loop; the array rows: 0 K1, 1 K2,
     counted without a probe); peak memory and graph pool;
  28. VerticalScalarDiffusivity: K1 (the fused flagship instance) against
     its plain version at rtol 2e-4, K3's constant-kappa pair bit for bit
     on the (u, v) and (T, S) solves of the state after 8 steps, one step
     against "torch", then 8 + 2x32 steps: per step 1 K1, 1 K2, 2 K3;
  29. ExplicitFreeSurface at dt = 5 s (the quasi-AB2 step damps the
     fastest gravity wave of the 80-degree rows below ~6 s; at 10 s u grew
     to non-finite values within 161 steps): one step against "torch"
     after 8, then 8 + 2x32 steps: per step 1 K1 (the unfused float32
     instance), 0 K2; fields and G_eta finite.

  the decomposed path brought up to the serial path, and
  compute_dtype="float32":
  31. the tripolar climate on the K6 route forced onto the 1x1 mesh (W =
     30): 8 steps, one step against "torch" on the tile at [24]'s
     tolerances, "ring" against "local" bit for bit, then in "local" 8 +
     2x32 steps replayed: per step exactly 1 K6, ceil(30 / s) K5, 3 K3, 1
     K4, 0 K1, 0 K2; the device loop against the host loop; finite
     fields, land at rest; ms/step beside [24]'s; then K6's tripolar
     instance against its plain version on the operands of one more tile
     step (the exchanged extension), bit for bit, timed;
  32. "float32" on the serial flagship (K1's unfused float32 instance, the
     AB2 update outside, K2): one step against "torch", 8 + 2x32 steps
     replayed, per step 1 K1, 1 K2; then a float64 state at 256x128x16
     under "auto": one step on the card, with no kernel launched (the
     plain versions, the JAX package's route for a non-float32 state),
     against the same step on the CPU within 1e-10 of each field's largest
     value; then "float32" and "bf16s" on that state after 8 steps, one
     step each against its "torch" step at [5]'s tolerances, with exactly
     one K1 launch (the unfused instance on float32 copies of the fields
     and the grid, as the JAX package casts them) and no other kernel;
  33. the further choices and "float32" on the forced 1x1 flagship: "bf16s",
     VerticalScalarDiffusivity, ExplicitFreeSurface (dt = 5 s) and
     "float32", each one step against its "torch" tile step (tolerances of
     [5]), then 8 + 2x32 steps replayed in "local" with per step 1 K1 (the
     bf16 instance; the unfused float32 one under the explicit free surface
     and "float32") and 0 K2, and ceil(30 / s) K5 (0 under the explicit
     free surface) and 2 K3 (vertical scalar); the device loop against the
     host loop; then the array modes "bfloat16", "float64" and "f32x2"
     (768x384x64) one step each on the tile, finite, 0 K1, 0 K2,
     ceil(30 / s) K5, their distance from the float32 tile step printed;
  34. K1's general instances (the schemes read at run time) against their
     plain versions at K1's tolerances, on the flagship's fields after 8
     steps: the 19 scheme combinations other than the flagship's
     (momentum_advection x ke_scheme x tracer_advection) on the flat
     two-tracer fused instance, the one-tracer b instance (b the linear
     buoyancy of T and S) fused and unfused float32, and the oracle's
     schemes on the islands, tripolar and k-epsilon operands; each timed,
     with its registers, ptxas spills and bound (``k1_bound``);
  35. K6's general instances bit for bit with the plain version: the 19
     combinations under TEOS-10, the linear equation of state with the
     oracle's schemes, the b tracer in one launch and as the split pair;
     each timed, with its bound (``k6_bound``);
  36. three main-path rows, each 8 steps, one step against its route's
     plain path at [5]'s tolerances (for (c) the K6 route with every
     wrapper's plain version, and in float64 against the "torch"
     route at 1e-10, ``k6_route_witness``),
     8 + 2x32 steps replayed with the launches per step
     held, the device loop against the host loop over 16 steps, the
     replayed loop's device busy and idle share under the profiler: (a) the oracle's schemes (centred
     vector-invariant momentum, standard kinetic energy, centred tracers)
     with the linear equation of state on the flagship, 1 K1 (general),
     1 K2; (b) the b-tracer flagship, 1 K1 (one tracer), 1 K2; (c) row (a)
     on the K6 route, 1 K6 (general), K5's launches at W = 4.
  every compute_dtype on every route and closure:
  37. every unfused K1 instance against its plain version at K1's
     tolerances, one launch each, the wall row 0: float32 and bf16
     storage, one to four tracers (b; T, S; T, S, e; T, S, e, eps) on the
     k-epsilon flagship's lat-lon operands and on the tripolar climate's
     planes, the flagship's schemes compiled in (two tracers or more) and
     the general instance (the oracle's schemes); each timed beside its
     plain version (one call) and its bound (``k1_bound``, unfused, 2-byte
     values in bf16 storage), with its registers, shared memory, blocks
     per SM and ptxas spills;
  38. K6's bfloat16 instances (one to four tracers, columns and planes) on
     those operands, f and the grid cast to bfloat16: one launch each,
     bfloat16 outputs bit for bit with the plain twin (float32 on the
     widened operands, each output rounded once; the run fails
     otherwise), timed beside the twin and ``k6_bound`` with 2-byte
     values, with the same launch line;
  39. rows (d)-(j), each 8 steps, one step against its route's plain path
     (every wrapper's plain version) at [5]'s tolerances, its distance
     from the float32 step printed, not bounded (as [27]), then 8 + 2x32
     steps replayed with the launches per step held and the profiler
     probe, finite fields (land at rest on the climate), the device loop
     against the host loop bit for bit over 16 steps: (d) the tripolar
     climate under "bf16s" (1 K1, bf16 storage, 3 tracers on planes; 1
     K2, 3 K3, 1 K4); (e) the same under "float32" (K1's unfused float32
     instance); (f) the k-epsilon flagship under "float32" (1 K1, four
     tracers; 1 K2, 4 K3, 1 k-epsilon K4); (g) the flagship on the K6
     route under "bfloat16" (1 K6, the bfloat16 instance; K5's launches
     at W = 4); (h) the tripolar climate on the K6 route under "bfloat16"
     (1 K6, K5, 3 K3, 1 K4); (i) the tripolar climate under the explicit
     free surface at dt = 5 s (1 K1 unfused float32, no K2, 3 K3, 1 K4);
     (j) row (d) on the forced 1x1 tile, "local", W = 30 (1 K1,
     ceil(30 / s) K5, no K2, 3 K3, 1 K4).
  the production-run path (outputs under smoke_out/, removed after each
  phase):
  40. the port's run script in this process, ``python -m
     gb25_tpu_torch.scripts.ocean_climate_simulation --resolution 0.25
     --Nz 64 --grid tripolar --dt 60 --sea-ice slab --output-format
     netcdf`` (1440x680x64, the synthetic restoring and initialization),
     70 steps in ``Simulation`` chunks of 10: only the Euler step runs
     eagerly (the run fails if a full chunk ran from the host), per step
     exactly 1 K1, 1 K2, 3 K3, 1 K4 on the device, the profiler over one
     more chunk and one host step; the script's own step
     (``coupled_ice_loop`` with the run's restoring dict, chunks of 10)
     from the run's last state replayed from the run's graph (no new
     capture) against the host loop over two chunks, bit for bit on
     ocean, ice, clock and iteration; K1, K2, K3 and K4 against their
     plain versions, and timed, on the operands one of its steps gave
     them at 1440x680x64; the NetCDF record read back, finite fields, land
     at rest, the ice in bounds; the atmosphere at a model time in the
     pre-regridded and the gather form (held to each other), the port's
     ``_increments`` with and without the restoring and the ice's step
     timed alone; ``Simulation.run``'s ms/step beside [13]'s;
  41. the slab ice at 1536x768x64 on the islands tripolar grid from a
     seeded polar cold (T = -2.2 degC poleward of 60 degrees, v = 1 m, a =
     0.9 poleward of 70) through ``coupled_ice_loop``: 8 + 2x32 steps
     replayed, the launches of [13] per step with the profiler probe, the
     device loop against the host loop bit for bit on ocean, ice, clock
     and iteration, v >= 0, 0 <= a <= 1, no ice on land or equatorward of
     40 degrees, growth in the cold band; ms/step beside [13]'s;
  42. kill and resume: ``python -m gb25_tpu_torch.scripts.run_10day
     --phase all --nx 1536 --nz 64 --dt 60 --days 0.1`` (144 steps, the
     checkpoint at step 72) as three subprocesses on the card; fails
     unless ``bitwise_equal`` on all 15 fields; each phase's ms/step with
     and without its checkpoints and each checkpoint's write time.
  the flagship's own entry points (outputs under smoke_out/, removed after):
  43. the serial run script's main in this process, ``python -m
     gb25_tpu_torch.scripts.baroclinic_instability_run --grid-x 1536
     --grid-y 768 --grid-z 64 --steps 64``, then again with ``--kernels
     pallas``: its five phase times (compile first_time_step, compile
     loop, first time step, first loop, second loop), per step exactly 1
     K1 and 1 K2 (K6 and K5's launches of [23] with pallas) over the run
     (the compile phase's step on a copy, the Euler step, 2 x 64 replayed
     from the one graph the compile phase captured) and under the profiler
     over one more replayed block and a host step; the final state bit for
     bit against the same 1 + 2 x 64 steps launched from the host; the
     second loop's ms/step beside [5]'s ([23]'s);
  44. the sharded run script on a group of one rank (tile 1536x768x64,
     64-step loops, dt 1 s, ``--save-dir``): 1 K1 and 1 K2 a step, the
     dumps read back bit for bit into the final state;
  45. the correctness protocol at 1536x768x64 f32 (noise 1e-3, dt 1e-9 s,
     the 100-step loop): the serial model against the decomposed model
     forced onto the 1x1 tile ("local": K1 and K5, no K2) at f32's rtol
     (sqrt(eps)) at all five checkpoints, each field's largest relative
     difference printed; per step 1 K1 in each model, 1 K2 in the serial
     one and K5's launches at W = 4 in the decomposed one;
  46. the eddy probe (``scripts.eddy_statistics.run``): (a) the JAX
     package's validated 1-degree run (360x160x8, dt 900 s, 1920 steps,
     chunks of 96), held to tests/test_eddy_statistics.py:82-91's band
     (EKE growth > 3, fit r2 > 0.9, 0.1 < sigma_fit / sigma_Eady < 1.2)
     and its EKE finite to day 16 (``EDDY_1DEG_FINITE_DAYS``), the chunks
     with a finite EKE and the day it went non-finite printed;
     (b) the balanced jet at 1536x768x64 (dt 90 s, noise 1e-5, 960 steps,
     chunks of 96): EKE finite and never below its first sample, growing;
     its fit printed beside docs/EDDY_VALIDATION.json's
     quarter_degree_balanced record; 1 K1 and 1 K2 a step in both.
  the last of the JAX package's surface:
  47. (a) K6's float64 instance against its plain twin at 1536x768x64 on
     the lat-lon flagship's operands (b alone, T and S under TEOS-10 and
     under the linear equation of state, four tracers) and on the tripolar
     climate's planes (three and four tracers), bit for bit (the run fails
     otherwise), each timed alone and plain, with its registers, shared
     memory, blocks per SM, spills and bound (8-byte values over 3.35 TB/s
     against its operations over 34 TFLOP/s FP64); (b) a float64 flagship
     state on kernels="pallas": one step with K6 against the same route's
     plain path bit for bit and against the "torch" route within 1e-12 of
     each field's largest value, then the main path (8 + 2x16 steps
     replayed, the probe) at 1 K6 launch a step and no K1, K2 or K5 (their
     plain versions run on float64), its ms/step (Gu and Gv against the
     "torch" route within 1e-10: that route's reduction sums the column
     total of b dz in another order); (c) compute_dtype="bf16x2"
     (paired-bfloat16 limbs, the array path) on the flagship at
     1536x768x64: one step from rest against the float32 step (distances
     printed, not bounded), finite; 1 + 2 steps from a device loop of
     2-step graphs bit for bit with the same 3 steps from the host, its
     ms/step replayed and from the host, 1 K2 a step; at 64x32x8 one step
     on the card against the same step on the CPU at [5]'s tolerances;
     (d) bf16x2 with CATKE on the tripolar climate at 1536x768x8 the same
     way (1 K2, 3 K3, 1 K4 a step).

Every phase raises on failure, and the script then exits non-zero. [30]
sums up the ms/step of every path; it is printed last, after [31]-[46],
then the script's wall time. Three lines end the output: a JSON
object with each kernel instance's launches on its main path, error
against its plain version, times, its bound (the larger of its compulsory
bytes over 3.35 TB/s and its operations over 67 TFLOP/s) and its library
time (null: no one PyTorch call computes any of these functions; K1's,
K2's, K3's, K5's and K6's entries carry their registers, shared memory per
block, tile and blocks per SM (K1's unfused instances' and K3's
constant-kappa entries, from [26]-[29], too), K2's its grid of tiles, cells a tile, its
instance and its L2 instance's check and time, K3's its levels in flight
and K5's its substeps a launch; K5's
entry also carries its column instance, its launches in "ring" and on the
decomposed flagship, under "k6_routes" its launches on each K6 route
with the checks, times and bounds of [23]'s and [24]'s blocks, and under
"tile_routes" its launches on [31]'s and [33]'s tiles, and its device
time behind a sleeping kernel (``device_ms``); K6's decomposed entry
([31]) carries the tripolar instance's check and times on the tile's own
operands; K1's unfused entries their launches under "float32" ([32]), on
a float64 state under "float32" and "bf16s" ([32]) and on [33]'s tiles;
the general instances' entries ([34]-[36]: K1's two-tracer general
instance on row (a), its one-tracer instance on row (b), K6's general
instance on row (c)) carry, beside their row's instance, each other scheme
combination, geometry and mode they were checked in, with its time, bound,
registers and spills; [37]-[39]'s entries (K1's unfused float32 instance on
row (e), its bf16-storage instance on row (d), K6's bfloat16 instance on
row (h), each the tripolar three-tracer instance) carry every instance
[37] or [38] checked under "instances" and their launches on the other
rows ((f), (i); (j); (g)); the tripolar K1 and K2 entries and the K3 and
K4 entries carry under "production_routes" their launches on [40] and
[41] and [40]'s check and times at its width; the flagship K1 and K2
entries, K6's flagship entry and K5's carry under "run_script_routes"
their launches on [43]-[46] with each path's steps;
each entry
of a replayed path carries its launches on the device over the run, the
method that established them and the device loop's eager and replayed
steps; ``launches`` stays the wrapper's count); then the
card's name and power limit; then
{"ok": true, "device": {...}}. Without a CUDA device it exits 2 and
prints no result. Times are CUDA-event means: ``ms`` of K1, K3 and K6 is
the kernel launch alone on operands prepared once (K3 summed over a step's
solves), of K4 its wrapper (the launch and one or two 1-D profile
reshapes), of K2 the whole 30-substep loop wrapper (one launch, the
plane building and un-weighting inside it), of K5 one block of 30 substeps (ceil(30 / s) launches);
``plain_ms`` is the plain version
on the same operands.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

import torch
import torch.distributed as dist

REFERENCE_CELL_STEPS_PER_SEC = 768 * 768 * 64 / 0.221  # GB-25 on one Alps GH200
NX, NY, NZ = 1536, 768, 64
RESOLUTION = 384 / NX  # the climate model's 1/4 degree: 1536 x 768
DT = 60.0
# the timed loops' steps: short enough that the whole script runs in about
# half its time limit (halved again when [37]-[39] came)
WARMUP, STEPS, PLAIN_STEPS = 8, 64, 3
CLIMATE_STEPS, CLIMATE_PLAIN_STEPS = 32, 2
K6_CLIMATE_STEPS, K6_KEPS_STEPS = 32, 32
TRIPOLAR_PLAIN_STEPS, KEPS_STEPS, KEPS_PLAIN_STEPS = 3, 32, 3
DECOMPOSED_W, DECOMPOSED_STEPS = 30, 32  # the bench's decomposed 1x1 rows
# the further run-script choices ([26]-[29]): steps of each timed loop; the
# cast array path's rows (eager tendency math, 0.13-0.16 s a step) run
# fewer, two blocks of the replayed graph, the f32x2 row at half width as
# bench.py:365 shrinks it. The explicit free surface's gravity waves (c =
# sqrt(g 4000 m) ~ 198 m/s) are stepped by the quasi-AB2 scheme, which
# damps a wave of frequency w only while w dt < ~0.55 (chi = 0.1): the
# fastest discrete wave at the 80-degree rows (dx ~ 4.5 km, dy ~ 23 km)
# has w ~ 0.089 /s, so dt = 5 s (10 s grew to non-finite u in 161 steps)
PRECISION_STEPS = {"bf16s": 32, "bfloat16": 32, "f32x2": 32}
F32X2_SHAPE = (768, 384, 64)
CHOICE_STEPS, EXPLICIT_STEPS, EXPLICIT_DT = 32, 32, 5.0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOP_PER_S = 67e12     # H100 SXM float32 outside the tensor cores


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps, warmup=1):
    """Mean device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, flops, flop_rate=None):
    """(bound_ms, bound_by): the least time for ``nbytes`` of compulsory
    traffic and ``flops`` operations at ``flop_rate`` (float32's by
    default)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (flop_rate or F32_FLOP_PER_S)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare(name, got, want, rtol, atol):
    """Raise if ``got`` is outside rtol/atol of ``want``; return the max
    absolute error."""
    got = got.double()
    want = want.double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values in the kernel output")
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-30)).max())
    bad = int((err > atol + rtol * want.abs()).sum())
    # atol may be a tensor (a bound per element): print its range
    atol_txt = (f"{float(atol):.1e}" if not torch.is_tensor(atol)
                else f"{float(atol.min()):.1e}..{float(atol.max()):.1e}")
    print(f"  {name:10s} max|ref| {float(want.abs().max()):.4e}  max abs err {max_abs:.3e}  "
          f"max rel err {max_rel:.3e}  (rtol {rtol:g}, atol {atol_txt}, outside: {bad})")
    if bad:
        raise AssertionError(f"{name}: {bad} elements outside rtol={rtol} atol={atol}")
    return max_abs


def sizes(grid):
    """Bytes of one interior field, one extended field, one interior plane
    and one extended plane in float32."""
    hx, hy, hz = grid.halo
    ext_plane = (grid.Ny + 2 * hy) * (grid.Nx + 2 * hx) * 4
    return (grid.Nx * grid.Ny * grid.Nz * 4, (grid.Nz + 2 * hz) * ext_plane,
            grid.Nx * grid.Ny * 4, ext_plane)


def k2_bound(grid, substeps, masked):
    """The loop reads eta, U, V, GU, GV, Hu and Hv (two mask planes; on
    the tripolar grid the five metric planes dyc, dxf, dxc, dyf and azc,
    else five columns) and writes three filtered planes; 14 (16 masked)
    operations per cell and substep, the Pallas kernel's own count."""
    _, _, plane, _ = sizes(grid)
    nbytes = (7 + (2 if masked else 0) + 5 * int(grid.north_fold) + 3) * plane
    return bound(nbytes, (16 if masked else 14) * substeps * grid.Nx * grid.Ny)


def k3_bound(grid, nf, damped, const_kappa=False):
    """Each solve reads its fields, kappa (a field unless constant) and the
    decay rate and writes the solutions; 6 + 4 nf (+2) operations per cell
    (the Pallas kernel's own count)."""
    n, _, _, _ = sizes(grid)
    return bound((2 * nf + int(not const_kappa) + int(damped)) * n,
                 (6 + 4 * nf + 2 * int(damped)) * grid.Nx * grid.Ny * grid.Nz)


def k4_bound(grid):
    """K4 reads u, v, b, e and the bottom plane extended and writes five
    interior fields; ~110 operations per cell, square roots and the tanh
    counted as one each (a hand count of the source)."""
    n, ext, _, ext_plane = sizes(grid)
    return bound(4 * ext + ext_plane + 5 * n, 110 * grid.Nx * grid.Ny * grid.Nz)


def k4_keps_bound(grid):
    """K4's k-epsilon function reads u, v, b, e and eps extended and writes
    six interior fields; ~50 operations per cell (a hand count of the
    source)."""
    n, ext, _, _ = sizes(grid)
    return bound(5 * ext + 6 * n, 50 * grid.Nx * grid.Ny * grid.Nz)


# operations of one reconstruction and its upwind selection, by tracer
# scheme (a hand count of csrc/tendency_tile.cuh: WENO-5's ~50)
RECON_OPS = {"weno5": 50, "centered2": 2, "upwind1": 1, "none": 0}


def stencil_ops(cfg, ntr):
    """Operations per cell of K1's stencils under ``cfg``'s schemes (a hand
    count of the source: 600 for the flagship's with two tracers): 120 for
    continuity, the pressure sums and gradient, the Coriolis products, the
    AB2 update and the integrals; the momentum advection (two
    reconstructions of q, WENO-5's or two operations each, 30 for the
    corner PV, the Bernoulli gradient and the vertical advection, the
    kinetic energy's 20 (Hollingsworth) or 8 (standard); none under
    "none"); per tracer three reconstructions and 15 for the fluxes and
    their divergence (none under "none")."""
    ops = 120
    if cfg.momentum_advection != "none":
        q = RECON_OPS["weno5"] if cfg.momentum_advection == "weno_vector_invariant" else 2
        ops += 2 * q + 30 + (20 if cfg.ke_scheme == "hollingsworth" else 8)
    if cfg.tracer_advection != "none":
        ops += ntr * (3 * RECON_OPS[cfg.tracer_advection] + 15)
    return ops


def eos_ops(cfg):
    """Operations of one buoyancy evaluation under ``cfg`` (TEOS-10 120: 48
    multiply-add pairs of its Horner scheme, the reduced variables and b;
    linear 6; the b tracer 0)."""
    from gb25_tpu_torch.ops.eos import LinearEquationOfState

    if "b" in cfg.tracers:
        return 0
    return 6 if isinstance(cfg.eos, LinearEquationOfState) else 120


def k1_bound(cfg, grid, ntr, immersed, fused=True, value_bytes=4, own=False):
    """K1 with ``ntr`` tracers under ``cfg``: it reads u, v, b and the
    tracers extended (b once where it is the "b" tracer: the wrapper passes
    that one tensor as both) and the column total of b. Fused, it reads the
    previous G of every field, (immersed) two face-bottom planes and
    (tripolar) the six metrics and f as extended planes, and writes the new
    G and the updated field of each and four integral planes; unfused (a
    value of ``value_bytes``: 4, or 2 stored as bfloat16), it writes the
    interior tendencies (and reads the tripolar planes too). Operations:
    ``stencil_ops``. ``own``: the instance that makes b, which reads no b
    and no column total but the fields b is made of (T and S, or b) a
    second time for the totals, and evaluates the buoyancy twice a cell
    (``eos_ops``), once for the totals and once on the level, besides the
    totals' sums (10)."""
    n, ext, plane, ext_plane = sizes(grid)
    nprog = 2 + ntr
    made_of = 1 if "b" in cfg.tracers else 2
    nread = 2 + ntr + (made_of if own else int("b" not in cfg.tracers))
    total = 0 if own else ext_plane
    if fused:
        nbytes = nread * ext + total + 3 * nprog * n + 4 * plane
        nbytes += 2 * plane if immersed else 0
    else:
        nbytes = nread * ext * value_bytes // 4 + total + nprog * n
    nbytes += 7 * ext_plane if grid.north_fold else 0
    ops = stencil_ops(cfg, ntr) + (2 * eos_ops(cfg) + 10 if own else 0)
    return bound(nbytes, ops * grid.Nx * grid.Ny * grid.Nz)


def k6_bound(cfg, grid, ntr, value_bytes=4):
    """K6 with ``ntr`` tracers under ``cfg``: it reads u, v and the tracers
    extended (a value of ``value_bytes``: 4, 2 in the bfloat16 instances,
    which also write bfloat16, or 8 in the float64 instance, whose metric
    planes are float64 too and whose operations run at the FP64 rate) and
    (tripolar) the six metrics and f as extended planes, and writes the
    interior G of each.
    Operations: ``stencil_ops`` less the AB2
    update and integrals K6 does not do (20), plus the buoyancy's
    (``eos_ops``) and the pre-pass's column sums (10)."""
    n, ext, _, ext_plane = sizes(grid)
    nprog = 2 + ntr
    nbytes = (nprog * ext + nprog * n) * value_bytes // 4
    f64 = value_bytes == 8
    nbytes += (7 * ext_plane * (2 if f64 else 1)) if grid.north_fold else 0
    ops = stencil_ops(cfg, ntr) - 20 + eos_ops(cfg) + 10
    return bound(nbytes, ops * grid.Nx * grid.Ny * grid.Nz, F64_FLOP_PER_S if f64 else None)


def launch_line(info, b):
    """An instance's launch shape and bound, for its phase's summary."""
    return (f"bound {b[0]:.3f} ms ({b[1]}); {info['registers']} registers, "
            f"{info['smem_bytes']} B shared memory per block, tile {info['tile'][0]}x"
            f"{info['tile'][1]}, {info['blocks_per_sm']} blocks per SM")


def build_kernels(kernels):
    """Build every kernel at once, one nvcc each; print the ptxas report."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k.load(), kernels))
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {k.source}: {line.strip()}")
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# the flagship baroclinic-instability ocean
# --------------------------------------------------------------------------

def phase_k1(cfg, grid, state, gen):
    """K1 against zslab_tendencies_plain on the flagship operands: the
    instance the step runs, which makes b itself, against the plain
    version that sums the column totals in the kernel's order; timed
    beside the instance that reads b and its total."""
    from gb25_tpu_torch.ops import pallas_zslab
    from gb25_tpu_torch.ops.halos import extend_field

    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}

    def noise():
        return 1e-7 * torch.randn(grid.shape, generator=gen, device=DEVICE)

    Gv_p = noise()
    Gv_p[:, 0, :] = 0.0
    prev = (noise(), Gv_p, {"T": noise(), "S": noise()})
    ab = (float(torch.tensor(DT * 1.6, dtype=torch.float32)),
          float(torch.tensor(DT * -0.6, dtype=torch.float32)))

    def run_kernel():  # no b handed in: the kernel makes it
        return pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab)

    def run_plain():
        return pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab,
                                                   sequential=True)

    got, want = run_kernel(), run_plain()
    torch.cuda.synchronize()
    errs = check_k1(got, want, ab, grid, ("T", "S"))
    del got, want

    # each instance and the plain version alone, the reading ones on buoyancy
    # and column total computed once; the reading instance after the eager
    # buoyancy, as a closure's step runs it
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    ms = cuda_time_ms(run_kernel, reps=10)
    read_ms = cuda_time_ms(
        lambda: pallas_zslab.zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab), reps=10)

    def run_reading():  # the eager buoyancy, then the instance that reads it
        buoyancy = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
        return pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab, buoyancy=buoyancy)

    wrapper_ms = cuda_time_ms(run_reading, reps=10)
    plain_ms = cuda_time_ms(
        lambda: pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be), reps=3)
    info = pallas_zslab.kernel_info(2, False, False, own=True)
    read_bound = k1_bound(cfg, grid, 2, False)
    print(f"  K1 CUDA kernel alone, making b (the step's instance) {ms:.3f} ms; reading b "
          f"{read_ms:.3f} ms (bound {read_bound[0]:.3f} ms, {read_bound[1]}); TEOS-10 + column "
          f"total + reading kernel {wrapper_ms:.3f} ms; plain version alone {plain_ms:.3f} ms; "
          + launch_line(info, k1_bound(cfg, grid, 2, False, own=True)))
    return {"max_abs_err": max(errs), "ms": ms, "read_ms": read_ms, "read_bound_ms": read_bound[0],
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms, "launch": info}


def check_k1(got, want, ab, grid, names, prev=None):
    """Compare K1's outputs with its plain version's; atol: tests/test_zslab.py's
    for the tendencies, the tendencies' tolerance carried through
    x* = x + dt c1 G (and its depth integral) for the updated fields, 2e-4
    of the largest integral for U0, V0. ``prev`` (the previous tendencies,
    given for the general instances, whose G is 0 under tracer advection
    "none"): the updated tracers' atol also holds 4 float32 ulps of the
    largest |dt c2 G_prev|, the rounding of the update's own sum, which the
    kernel fuses into a multiply-add (where x* cancels to near 0, its
    relative error is large)."""
    Gu, Gv, Gtr, un, vn, trn, ints = got
    wGu, wGv, wGtr, wun, wvn, wtrn, wints = want
    a = ab[0]
    H = float(grid.dz_c[grid.hz : grid.hz + grid.Nz].sum())
    gmax = {"u": float(wGu.abs().max()), "v": float(wGv.abs().max()),
            **{k: float(wGtr[k].abs().max()) for k in names}}
    sum_ulps = {k: 0.0 for k in names}
    if prev is not None:
        eps = torch.finfo(torch.float32).eps
        sum_ulps = {k: 4 * eps * abs(ab[1]) * float(prev[2][k].abs().max()) for k in names}
    errs = [compare("Gu", Gu, wGu, 2e-4, 1e-9), compare("Gv", Gv, wGv, 2e-4, 1e-9)]
    errs += [compare("G" + k, Gtr[k], wGtr[k], 2e-4, 1e-7) for k in names]
    errs += [compare("u*", un, wun, 2e-4, a * 2e-4 * gmax["u"]),
             compare("v*", vn, wvn, 2e-4, a * 2e-4 * gmax["v"])]
    errs += [compare(k + "*", trn[k], wtrn[k], 2e-4, a * 2e-4 * gmax[k] + sum_ulps[k])
             for k in names]
    atols = [2e-4 * float(wints[0].abs().max()), 2e-4 * float(wints[1].abs().max()),
             2e-4 * float(wints[2].abs().max()) + a * 2e-4 * gmax["u"] * H,
             2e-4 * float(wints[3].abs().max()) + a * 2e-4 * gmax["v"] * H]
    errs += [compare(n, g, w, 2e-4, at)
             for n, g, w, at in zip(("U0", "V0", "Us", "Vs"), ints, wints, atols)]
    if float(vn[:, 0, :].abs().max()) != 0.0:
        raise AssertionError("K1 left v* nonzero on the south wall row")
    return errs


def phase_k2(cfg, grid, state, gen):
    """K2 against the plain path at 1536x768."""
    from gb25_tpu_torch.models.free_surface import face_depths

    dz = grid.dz_c[grid.hz : grid.hz + grid.Nz]
    U0 = (state.u * dz).sum(0)
    V0 = (state.v * dz).sum(0)
    eta0 = 1e-2 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GU = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GV = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GV[0] = 0.0
    Hu, Hv = face_depths(grid)
    return time_k2(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, None, None)


def time_k2(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, mu, mv):
    """K2 against the plain path (plane building, plain substeps,
    un-weighting) bit for bit, in the instance the size takes and in the L2
    instance; both timed, the plain path timed."""
    from gb25_tpu_torch.ops import pallas_barotropic as pb

    cfg_plain = dataclasses.replace(cfg, kernels="torch")

    def run(c):
        return pb.barotropic_loop(c, grid, eta0, U0, V0, GU, GV, Hu, Hv, DT, mu=mu, mv=mv)

    ops = pb.loop_operands(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, DT, mu, mv)
    got, want = run(cfg), run(cfg_plain)
    l2 = pb._barotropic_loop_cuda(*ops, on_chip=False)
    torch.cuda.synchronize()
    names = ("eta_b", "U_b", "V_b")
    errs = [compare(n, x, y, 0.0, 0.0) for n, x, y in zip(names, got, want)]
    l2_errs = [compare(n + " L2", x, y, 0.0, 0.0) for n, x, y in zip(names, l2, want)]
    del got, want, l2
    ms = cuda_time_ms(lambda: run(cfg), reps=20)
    l2_ms = cuda_time_ms(lambda: pb._barotropic_loop_cuda(*ops, on_chip=False), reps=20)
    plain_ms = cuda_time_ms(lambda: run(cfg_plain), reps=5)
    masked, tripolar = mu is not None, grid.north_fold
    info = pb.loop_info(masked, tripolar)
    plan = pb.launch_plan(grid.Nx, grid.Ny, masked, tripolar)
    launch = {"registers": info["registers"], "smem_bytes": plan.get("smem_bytes", 0),
              "tile": plan.get("tile", [0, 0]), "blocks_per_sm": info["blocks_per_sm"],
              "grid": plan.get("grid", [0, 0]), "cells": plan.get("cells", 0),
              "instance": plan["instance"]}
    print(f"  K2 loop of {cfg.free_surface.substeps} substeps in one launch: {ms:.3f} ms "
          f"({plan['instance']} instance; L2 instance {l2_ms:.3f} ms, {info['l2_registers']} "
          f"registers, {info['l2_blocks_per_sm']} blocks per SM); plain {plain_ms:.3f} ms; "
          f"{info['registers']} registers, {launch['smem_bytes']} B shared memory per block, "
          f"{info['blocks_per_sm']} blocks per SM, grid {launch['grid'][0]}x{launch['grid'][1]} "
          f"tiles of {launch['tile'][0]}x{launch['tile'][1]} ({launch['cells']} cells)")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bitwise": True,
            "launch": launch,
            "l2": {"max_abs_err": max(l2_errs), "ms": l2_ms, "registers": info["l2_registers"],
                   "blocks_per_sm": info["l2_blocks_per_sm"]}}


def phase_step_compare(step, plain_step, state):
    """One step of the kernel path against one of the plain path from
    ``state``: rtol 1e-3 and an atol of 1e-3 of each field's largest value
    (at most 5e-6), so a small field such as e or a G is held to its own
    scale."""
    def fields(s):
        return {"u": s.u, "v": s.v, "eta": s.eta, **s.tracers,
                "Gu": s.Gu, "Gv": s.Gv, **{"G" + k: g for k, g in s.Gtracers.items()}}

    a = fields(step(state))
    b = fields(plain_step(state))
    for name in a:
        compare(name, a[name], b[name], 1e-3, min(5e-6, 1e-3 * float(b[name].abs().max())))


def check_state(state, shape):
    fields = {"u": state.u, "v": state.v, "eta": state.eta, **state.tracers}
    for name, f in fields.items():
        if not torch.isfinite(f).all():
            raise AssertionError(f"{name} is not finite after the run")
    umax = float(state.u.abs().max())
    if not 0.0 < umax < 10.0:
        raise AssertionError(f"max|u| = {umax} m/s is not a sane ocean velocity")
    if tuple(state.u.shape) != shape or tuple(state.eta.shape) != shape[1:]:
        raise AssertionError(f"unexpected shapes {tuple(state.u.shape)}, {tuple(state.eta.shape)}")
    return umax


def timed_loop(step_n, state, warmup, steps):
    """Warm up, run ``steps`` once, then time a second ``steps``."""
    s = step_n(state, warmup)
    s = step_n(s, steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = step_n(s, steps)
    torch.cuda.synchronize()
    return s, time.perf_counter() - t0


def flagship(card):
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(1234)
    print(f"[3] flagship K1 vs plain at {NX}x{NY}x{NZ}")
    k1 = phase_k1(cfg, grid, state, gen)
    print(f"[4] flagship K2 vs plain at {NX}x{NY}")
    k2 = phase_k2(cfg, grid, state, gen)
    torch.cuda.empty_cache()

    print("[5] flagship main path: one step, kernels='auto' vs 'torch'")
    cfg_plain = dataclasses.replace(cfg, kernels="torch")
    phase_step_compare(lambda s: time_step(cfg, grid, s, DT),
                       lambda s: time_step(cfg_plain, grid, s, DT), state)
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    step_n = lambda st, n: loop(cfg, grid, st, DT, n)  # noqa: E731
    s, elapsed, launches, _, loop_rec = run_main_path(step_n, state, kernels,
                                                      {"K1": 1, "K2": 1}, STEPS)
    substeps = cfg.free_surface.substeps
    umax = check_state(s, (NZ, NY, NX))
    ms_step = 1e3 * elapsed / STEPS
    rate = NX * NY * NZ * STEPS / elapsed
    print(f"  max|u| = {umax:.4f} m/s")
    host_ms = loop_vs_host("flagship", step_n, host_steps(
        lambda st: time_step(cfg, grid, st, DT, premasked=True), grid), s, ms_step)
    del s

    print(f"[6] flagship plain path, {PLAIN_STEPS} steps")
    sp, plain_elapsed = timed_loop(lambda st, n: loop(cfg_plain, grid, st, DT, n), state, 0,
                                   PLAIN_STEPS)
    plain_ms_step = 1e3 * plain_elapsed / PLAIN_STEPS
    check_state(sp, (NZ, NY, NX))
    print(f"  flagship {NX}x{NY}x{NZ} f32 on {card}: {ms_step:.3f} ms/step, "
          f"{rate:.4e} cell-steps/s ({rate / REFERENCE_CELL_STEPS_PER_SEC:.3f}x GB-25 on one "
          f"GH200), timed second {STEPS}-step loop, replayed; launched from the host "
          f"{host_ms:.3f} ms/step; plain torch {plain_ms_step:.3f} ms/step")

    k1_b, k1_by = k1_bound(cfg, grid, 2, False, own=True)
    k2_b, k2_by = k2_bound(grid, substeps, False)
    return [
        {"name": "zslab_tendencies", "route": "cuda",
         "source": "gb25_tpu_torch/csrc/zslab_tendencies.cu",
         "replaces": "gb25_tpu/ops/pallas_zslab.py:275", "path": "flagship",
         "launches": launches["K1"], "max_abs_err": k1["max_abs_err"], "ms": k1["ms"],
         "read_ms": k1["read_ms"], "read_bound_ms": k1["read_bound_ms"],
         "wrapper_ms": k1["wrapper_ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1_b, "bound_by": k1_by, "library_ms": None, **k1["launch"],
         **on_device(loop_rec, "K1")},
        {"name": "barotropic_loop", "route": "cuda",
         "source": "gb25_tpu_torch/csrc/barotropic_loop.cu",
         "replaces": "gb25_tpu/ops/pallas_barotropic.py:94", "path": "flagship",
         "launches": launches["K2"], "max_abs_err": k2["max_abs_err"], "ms": k2["ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2_b, "bound_by": k2_by, "library_ms": None,
         "bitwise": k2["bitwise"], **k2["launch"], "l2": k2["l2"], **on_device(loop_rec, "K2")},
    ], {"ms_step": ms_step, "rate": rate, "plain_ms_step": plain_ms_step,
        "host_ms_step": host_ms, "loop": loop_rec}


# --------------------------------------------------------------------------
# the coupled climate model
# --------------------------------------------------------------------------

def climate_operands(cfg, grid, state, gen):
    """Perturbed, masked, extended climate fields and previous tendencies:
    currents of ~0.05 m/s, a T perturbation, TKE between 1e-5 and 2e-5."""
    from gb25_tpu_torch.grids.immersed import face_masks
    from gb25_tpu_torch.ops.halos import extend_field
    from gb25_tpu_torch.ops.pallas_zslab import column_buoyancy

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=DEVICE)

    um, vm = face_masks(grid)
    ue = extend_field(grid, noise(0.05), "u") * um
    ve = extend_field(grid, noise(0.05), "v") * vm
    tr = {"T": state.tracers["T"] + noise(0.1), "S": state.tracers["S"],
          "e": 1e-5 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE))}
    tr_e = {k: extend_field(grid, c, "c") for k, c in tr.items()}
    be, b_total = column_buoyancy(cfg, grid, tr_e)
    Gv_p = noise(1e-7)
    Gv_p[:, 0, :] = 0.0
    prev = (noise(1e-7), Gv_p, {k: noise(1e-7) for k in tr})
    return ue, ve, tr_e, be, b_total, prev


def phase_k4(cfg, grid, ue, ve, be, ee):
    from gb25_tpu_torch.ops import pallas_catke

    got = pallas_catke.catke_diffusivities_kernel(cfg, grid, ue, ve, be, ee)
    want = pallas_catke.catke_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee)
    torch.cuda.synchronize()
    errs = [compare(n, g, w, 1e-6, 1e-12 * float(w.abs().max()))
            for n, g, w in zip(("kappa_u", "kappa_c", "kappa_e", "G_e", "lam_e"), got, want)]
    ms = cuda_time_ms(lambda: pallas_catke.catke_diffusivities_kernel(cfg, grid, ue, ve, be, ee),
                      reps=10)
    plain_ms = cuda_time_ms(
        lambda: pallas_catke.catke_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee), reps=3)
    print(f"  K4 {ms:.3f} ms; plain {plain_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}, got


def phase_k3(cfg, grid, solves):
    """K3 against its plain version on each of ``solves`` (name -> (fields,
    kappa, damping)): the solves of one step, timed launch by launch."""
    from gb25_tpu_torch.ops import pallas_tridiag

    dzc = grid.dz_c[grid.hz : grid.hz + grid.Nz]
    dzf = grid.dz_f[grid.hz : grid.hz + grid.Nz]
    a_lam, a_mu = pallas_tridiag.vertical_coefficients(DT, dzc, dzf)
    out = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "per_solve_ms": {},
           "per_solve_launch": {}, "bound_ms": 0.0}
    for name, (fields, kappa, damp) in solves.items():
        got = pallas_tridiag.implicit_diffusion(cfg, fields, kappa, DT, dzc, dzf, damp)
        want = pallas_tridiag.implicit_diffusion_plain(fields, kappa, DT, a_lam, a_mu, damp)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, want)):  # bit for bit
            err = compare(f"{name}[{i}]", g, w, 0.0, 0.0)
            out["max_abs_err"] = max(out["max_abs_err"], err)
        ms = cuda_time_ms(
            lambda: pallas_tridiag.implicit_kernel(fields, kappa, DT, a_lam, a_mu, damp), reps=10)
        plain_ms = cuda_time_ms(
            lambda: pallas_tridiag.implicit_diffusion_plain(fields, kappa, DT, a_lam, a_mu, damp),
            reps=2)
        const = isinstance(kappa, float)
        b = k3_bound(grid, len(fields), damp is not None, const)
        info = pallas_tridiag.kernel_info(grid.Nz, len(fields), damp is not None, const)
        print(f"  K3 {name}: {ms:.3f} ms; plain {plain_ms:.3f} ms; bit for bit; "
              + launch_line(info, b) + f", {info['levels_in_flight']} levels in flight")
        out["ms"] += ms
        out["plain_ms"] += plain_ms
        out["bound_ms"] += b[0]
        out["per_solve_ms"][name] = ms
        out["per_solve_launch"][name] = info
    out["launch"] = next(iter(out["per_solve_launch"].values()))
    return out


def phase_k1_instance(cfg, grid, ue, ve, tr_e, be, b_total, prev, label, ab=None):
    """K1 against its plain version on the operands of one instance (the
    immersed integrals where the grid is immersed); ``ab``: the AB2
    coefficients (dt c1, dt c2), by default those of a step of DT."""
    from gb25_tpu_torch.grids.immersed import face_bottom_planes
    from gb25_tpu_torch.ops import pallas_zslab

    fb = face_bottom_planes(grid) if grid.immersed else None
    ab = ab or (float(torch.tensor(DT * 1.6, dtype=torch.float32)),
                float(torch.tensor(DT * -0.6, dtype=torch.float32)))
    got = pallas_zslab.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab,
                                        buoyancy=(be, b_total), face_bottoms=fb)
    want = pallas_zslab.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb)
    torch.cuda.synchronize()
    errs = check_k1(got, want, ab, grid, tuple(tr_e))
    del got, want
    ms = cuda_time_ms(lambda: pallas_zslab.zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total,
                                                        prev, ab, fb), reps=10)
    plain_ms = cuda_time_ms(lambda: pallas_zslab.zslab_tendencies_plain(
        cfg, grid, ue, ve, tr_e, prev, ab, be, fb), reps=3)
    info = pallas_zslab.kernel_info(len(tr_e), fb is not None, grid.north_fold)
    print(f"  K1 {label} instance alone {ms:.3f} ms; plain {plain_ms:.3f} ms; "
          + launch_line(info, k1_bound(cfg, grid, len(tr_e), fb is not None)))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "launch": info}


def phase_k2_masked(cfg, grid, ue, ve, gen):
    from gb25_tpu_torch.models.free_surface import face_depths

    dz = grid.dz_c[grid.hz : grid.hz + grid.Nz]
    U0 = (grid.interior(ue) * dz).sum(0)
    V0 = (grid.interior(ve) * dz).sum(0)
    Hu, Hv = face_depths(grid)
    mu, mv = grid.geometry.mu, grid.geometry.mv
    eta0 = 1e-2 * torch.randn((NY, NX), generator=gen, device=DEVICE)
    GU = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE) * mu
    GV = 1e-4 * torch.randn((NY, NX), generator=gen, device=DEVICE) * mv
    GV[0] = 0.0
    return time_k2(cfg, grid, eta0, U0, V0, GU, GV, Hu, Hv, mu, mv)


def check_climate_state(state, grid, shape=None):
    from gb25_tpu_torch.grids.immersed import interior_masks
    from gb25_tpu_torch.models.free_surface import face_depths

    umax = check_state(state, shape or (NZ, NY, NX))
    if float(state.tracers["e"].min()) < 0.0:
        raise AssertionError("e < 0 after the run")
    Hu, Hv = face_depths(grid)
    land = grid.bottom_height == 0.0
    if int(land.sum()) == 0 or int((Hu == 0).sum()) == 0:
        raise AssertionError("no land column on the islands grid")
    u_land = float(state.u[:, Hu == 0].abs().max())
    v_land = float(state.v[:, Hv == 0].abs().max())
    eta_land = float(state.eta[land].abs().max())
    if u_land != 0.0 or v_land != 0.0 or eta_land != 0.0:
        raise AssertionError(f"land not at rest: |u| {u_land}, |v| {v_land}, |eta| {eta_land}")
    # below the bottom of a partly fluid column the implicit solves, which
    # run after the re-mask, leave values on solid faces (in the JAX
    # package too); the next step masks them before any use
    um, vm = interior_masks(grid)
    below = max(float((state.u * (1 - um)).abs().max()), float((state.v * (1 - vm)).abs().max()))
    print(f"  {int(land.sum())} land columns at rest; solid faces below partial columns: "
          f"max |u|, |v| {below:.3e} m/s (max|u| {umax:.4f} m/s)")
    return umax


def run_main_path(step_n, state, kernels, per_step, steps, probe=True):
    """Set every launch count and the device loop's tallies to 0, run the
    main path (``WARMUP`` steps, ``steps`` untimed, ``PROBE_STEPS`` under
    the profiler, ``steps`` timed), read the counts and hold each kernel's
    launches on the device to ``per_step`` (name -> launches per step) x
    the steps, exactly.

    A replay does not pass through the kernels' wrappers. Each capture
    reads the wrappers' counts before and after it: the launches it
    recorded, which ran nothing then and run at every replay. So a kernel's
    launches on the device are its wrapper's count less what captures
    recorded plus what replays made (``device_loop.STATS.launches``), and
    the wrappers' counts alone must be per step x (eager + recorded steps).
    The probe holds those counts to the device: in that window of the run
    (one replayed block and one step from the host) the profiler must see
    per step x ``PROBE_STEPS`` launches of each kernel; where it sees the
    host step's launches and none of the block's (a profiler that does not
    trace inside a graph) the counts stand alone, and the method says so.
    A probe that sees more fails the run; one that sees fewer (lost
    records) is run again, and the run fails if ``PROBE_ATTEMPTS`` probes
    all see fewer. Without a replay (a loop run from the host) every
    step passes through the wrappers and the profiler must see all of a
    probe's. ``probe=False`` (the cast array path's rows, whose eager
    tendency math launches hundreds of small kernels a step) runs no probe:
    the counts stand alone. Returns (state, elapsed, launches on the
    device, peak GB, the loop's record)."""
    from gb25_tpu_torch.models import device_loop

    gc.collect()  # earlier phases' cyclic garbage would count in the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    stats = device_loop.STATS
    stats.reset()
    s = step_n(step_n(state, WARMUP), steps)
    probe_want = {name: n * PROBE_STEPS for name, n in per_step.items()}
    probes, seen, probe_replayed = [], {}, 0
    while probe:
        if len(probes) == PROBE_ATTEMPTS:
            raise AssertionError(f"the profiler saw fewer launches than {probe_want} in each of "
                                 f"{PROBE_ATTEMPTS} probes of {PROBE_STEPS} steps: {probes}")
        replayed_before, probe_from = stats.replayed_steps, s
        seen, s = device_launches(lambda: step_n(probe_from, PROBE_STEPS), per_step)
        probe_replayed = stats.replayed_steps - replayed_before
        host_only = {name: n * (PROBE_STEPS - probe_replayed) for name, n in per_step.items()}
        probes.append(seen)
        if any(seen[name] > probe_want[name] for name in per_step):
            raise AssertionError(f"the profiler saw {seen} launches over {PROBE_STEPS} probe steps, "
                                 f"more than the {probe_want} the steps make")
        if seen == probe_want or (probe_replayed and seen == host_only):
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = step_n(s, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    calls = {name: k.launches for name, k in kernels.items()}
    launches = {name: stats.launches(k) for name, k in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = WARMUP + 2 * steps + len(probes) * PROBE_STEPS
    replayed = stats.replays > 0
    if replayed and stats.eager_steps + stats.replayed_steps != n_steps:
        raise AssertionError(f"{stats.eager_steps} eager and {stats.replayed_steps} replayed "
                             f"steps do not make up the {n_steps} steps")
    wrapper_steps = stats.eager_steps + stats.captured_steps if replayed else n_steps
    want_calls = {name: n * wrapper_steps for name, n in per_step.items()}
    want = {name: n * n_steps for name, n in per_step.items()}
    if calls != want_calls or launches != want:
        raise AssertionError(f"launches on the device {launches} over {n_steps} steps, expected "
                             f"{want}; through the wrappers {calls} over {wrapper_steps} steps, "
                             f"expected {want_calls}")
    counted = ("eager launches + capture-time counts x replays" if replayed
               else "wrapper counts (host loop, no replay)")
    lost = (f" (after {len(probes) - 1} probe(s) whose records the profiler lost in part: "
            f"{probes[:-1]})" if len(probes) > 1 else "")
    if not probe:
        method = f"{counted}; no profiler probe"
    elif seen == probe_want:
        method = f"{counted}; the profiler saw all {PROBE_STEPS} probe steps' launches{lost}"
    else:
        method = (f"{counted}; the profiler saw the probe's {PROBE_STEPS - probe_replayed} host "
                  f"step(s) and no kernel of its {probe_replayed} replayed steps{lost}")
    record = {"steps": n_steps, "eager_steps": stats.eager_steps,
              "replayed_steps": stats.replayed_steps, "captured_steps": stats.captured_steps,
              "replays": stats.replays, "block": device_loop.BLOCK_STEPS,
              "pool_gb": stats.pool_bytes / 1e9, "peak_gb": peak_gb, "method": method,
              "wrapper_calls": calls, "probe": {"steps": PROBE_STEPS, "attempts": len(probes),
                                                "replayed_steps": probe_replayed, "seen": seen}}
    how = (f"{stats.eager_steps} eager, {stats.captured_steps} recorded by a capture; "
           f"{stats.replayed_steps} steps replayed in {stats.replays} replays of "
           f"{device_loop.BLOCK_STEPS}-step graphs" if replayed else "every step from the host")
    print(f"  launches on the device over {n_steps} steps: {launches}, by {method} (profiler "
          f"{seen}); through the wrappers {calls} ({wrapper_steps} steps: {how}); iteration "
          f"{s.iteration}; peak device memory {peak_gb:.2f} GB, graph pools "
          f"{record['pool_gb']:.2f} GB")
    return s, elapsed, launches, peak_gb, record


# one replayed block and one step from the host: the main path's window
# under the profiler. The profiler was seen to lose records of a busy
# window, in runs of 512 (on the tripolar K6 route, ~24,000 records in 17
# steps: one probe in nine lost a step's K5 and K3 launches), never to add
# any: a probe that sees fewer is run again, up to PROBE_ATTEMPTS in all.
# A kernel a graph does not launch is missing from every replay, so a
# repeat hides no fault; a probe that sees more fails at once.
PROBE_STEPS, PROBE_ATTEMPTS = 17, 4


def device_launches(run, names):
    """The launches of each kernel of ``names`` that the profiler sees on the
    device while ``run()`` runs, by the kernel's symbol
    (``profiling.KERNELS``); ``run()``'s result. The count ends at a marker
    kernel launched after ``run()``, and the window runs on past it, so
    that work queued after the run is not counted (where the profiler lost
    the marker, every record counts)."""
    from torch.profiler import ProfilerActivity, profile

    from gb25_tpu_torch.utils.profiling import KERNELS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda._sleep(1000)  # the marker: ATen's spin_kernel
        pad = torch.zeros(1, device=DEVICE)
        for _ in range(64):
            pad.add_(1.0)
        torch.cuda.synchronize()
    on_device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    end = min((e.time_range.start for e in on_device if "spin_kernel" in e.name),
              default=float("inf"))
    counts = dict.fromkeys(names, 0)
    for e in on_device:
        if e.time_range.start < end:
            for name in names:
                if KERNELS[name][0] in e.name:
                    counts[name] += 1
    return counts, out


def loop_vs_host(label, step_n, host_n, state, loop_ms, n=None):
    """The device loop (``step_n``, replayed from its kept graph) against the
    host loop (``host_n``, every step launched from the host) over ``n``
    steps (BLOCK_STEPS by default) from ``state``: bit for bit on every
    field, the clock and the iteration. Every kernel is deterministic and
    bit for bit with its plain twin, so a difference is the loop's fault (a
    stale cache, an aliased buffer, a host scalar baked into the graph).
    Both timed, the host loop on its second run; ``loop_ms``: the main
    path's replayed ms/step. Returns the host loop's ms/step."""
    from gb25_tpu_torch.models import device_loop

    n = n or device_loop.BLOCK_STEPS
    device_loop.STATS.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = step_n(state, n)
    torch.cuda.synchronize()
    t_loop = time.perf_counter() - t0
    if device_loop.STATS.replays == 0:
        raise AssertionError(f"{label}: the device loop replayed no graph")
    host_n(state, n)  # untimed: the allocator's own pool refills after the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b = host_n(state, n)
    torch.cuda.synchronize()
    t_host = time.perf_counter() - t0
    ta, tb = device_loop._tensors(a), device_loop._tensors(b)
    differ = [f for f in ta if not torch.equal(ta[f], tb[f])]
    if differ or a.iteration != b.iteration or list(ta) != list(tb):
        raise AssertionError(f"{label}: the device loop differs from the host loop in {differ} "
                             f"(iteration {a.iteration} vs {b.iteration})")
    host_ms = 1e3 * t_host / n
    print(f"  device loop vs host loop over {n} steps from iteration {state.iteration}: bit for "
          f"bit in {len(ta)} tensors (every field, the clock), iteration {a.iteration}; "
          f"{device_loop.STATS.replays} replay, {device_loop.STATS.eager_steps} eager steps; "
          f"{1e3 * t_loop / n:.3f} ms/step replayed in this call, {host_ms:.3f} ms/step from the "
          f"host ({loop_ms:.3f} ms/step replayed in the timed loop)")
    return host_ms


def host_steps(step, grid):
    """``step`` launched from the host ``n`` times, from the state masked as
    the loops mask it: the device loop's eager twin."""
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.models.hydrostatic import premask_state

    return lambda st, n: device_loop.host_loop(step, premask_state(grid, st), n)


def on_device(loop_rec, name):
    """A kernel entry's record of how its path ran through the device loop:
    the method that counted its launches, its wrapper's calls, what the
    profiler saw in the probe, the steps run eagerly and replayed, the
    block."""
    return {"launch_method": loop_rec["method"], "wrapper_calls": loop_rec["wrapper_calls"][name],
            "profiler_probe": loop_rec["probe"]["seen"][name],
            "device_loop": {k: loop_rec[k] for k in ("eager_steps", "replayed_steps", "block")}}


def entry(name, source, replaces, path, launches, res, b):
    """One kernel instance's record for the kernels line."""
    return {"name": name, "route": "cuda", "source": "gb25_tpu_torch/csrc/" + source,
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None, **res.get("launch", {})}


def climate(card, grid_type, first):
    """The coupled climate path on ``grid_type``: the lat-lon islands grid
    (phases ``first`` .. ``first`` + 4: K4, K3, K1 and K2, the main path,
    the plain path) or the tripolar grid (``first`` .. ``first`` + 2: K1
    and K2, the main path, the plain path)."""
    from gb25_tpu_torch import coupled_loop, coupled_time_step, data_free_ocean_climate_model
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_catke, pallas_tridiag, pallas_zslab

    ccfg, grid, atmos, state = data_free_ocean_climate_model(resolution=RESOLUTION, Nz=NZ,
                                                             device=DEVICE, grid_type=grid_type)
    tripolar = grid.north_fold
    assert grid.shape == (NZ, NY, NX) and grid.immersed and tripolar == (
        grid_type == "gaussian_islands_tripolar")
    cfg = ccfg.ocean
    gen = torch.Generator(device=DEVICE).manual_seed(4321)
    ue, ve, tr_e, be, b_total, prev = climate_operands(cfg, grid, state, gen)
    phase = first
    entries = []
    if not tripolar:
        print(f"[{phase}] K4 vs plain at {NX}x{NY}x{NZ} (Gaussian islands, CATKE)")
        k4, diffs = phase_k4(cfg, grid, ue, ve, be, tr_e["e"])
        ku, kc, ke, _, lam = diffs

        def inner(t):
            return grid.interior(t).contiguous()

        print(f"[{phase + 1}] K3 vs plain: the (u, v), (T, S) and damped e solves")
        k3 = phase_k3(cfg, grid, {"u,v": ((inner(ue), inner(ve)), ku, None),
                                  "T,S": ((inner(tr_e["T"]), inner(tr_e["S"])), kc, None),
                                  "e": ((inner(tr_e["e"]),), ke, lam)})
        del diffs, ku, kc, ke, lam
        phase += 2
    label = "tripolar climate" if tripolar else "climate"
    print(f"[{phase}] K1 {label} instance vs plain; K2 {'fold' if tripolar else 'masked'} "
          "instance vs plain")
    k1c = phase_k1_instance(cfg, grid, ue, ve, tr_e, be, b_total, prev, label)
    k2m = phase_k2_masked(cfg, grid, ue, ve, gen)
    del ue, ve, tr_e, be, b_total, prev
    torch.cuda.empty_cache()

    print(f"[{phase + 1}] {label} main path: {WARMUP} coupled steps, then one step "
          "kernels='auto' vs 'torch'")
    plain = dataclasses.replace(ccfg, ocean=dataclasses.replace(cfg, kernels="torch"))
    moved = coupled_loop(ccfg, grid, atmos, state, DT, WARMUP)
    print(f"  after {WARMUP} steps: max|u| {float(moved.u.abs().max()):.4e} m/s, "
          f"max e {float(moved.tracers['e'].max()):.4e} m^2/s^2")
    phase_step_compare(lambda s: coupled_time_step(ccfg, grid, atmos, s, DT),
                       lambda s: coupled_time_step(plain, grid, atmos, s, DT), moved)
    del moved
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K3": pallas_tridiag.KERNEL, "K4": pallas_catke.KERNEL}
    per_step = {"K1": 1, "K2": 1, "K3": 3, "K4": 1}
    step_n = lambda st, n: coupled_loop(ccfg, grid, atmos, st, DT, n)  # noqa: E731
    s, elapsed, launches, _, loop_rec = run_main_path(step_n, state, kernels, per_step,
                                                      CLIMATE_STEPS)
    check_climate_state(s, grid)
    ms_step = 1e3 * elapsed / CLIMATE_STEPS
    rate = NX * NY * NZ * CLIMATE_STEPS / elapsed
    host_ms = loop_vs_host(label, step_n, host_steps(
        lambda st: coupled_time_step(ccfg, grid, atmos, st, DT, premasked=True), grid), s,
        ms_step)
    del s

    plain_steps = TRIPOLAR_PLAIN_STEPS if tripolar else CLIMATE_PLAIN_STEPS
    print(f"[{phase + 2}] {label} plain path, {plain_steps} steps")
    sp, plain_elapsed = timed_loop(lambda st, n: coupled_loop(plain, grid, atmos, st, DT, n),
                                   state, 0, plain_steps)
    check_state(sp, (NZ, NY, NX))
    plain_ms_step = 1e3 * plain_elapsed / plain_steps
    print(f"  {label} {NX}x{NY}x{NZ} f32 on {card}: {ms_step:.3f} ms/step, {rate:.4e} "
          f"cell-steps/s, timed second {CLIMATE_STEPS}-step loop, replayed; launched from the "
          f"host {host_ms:.3f} ms/step; plain torch {plain_ms_step:.3f} ms/step")

    substeps = cfg.free_surface.substeps
    path = "climate_tripolar" if tripolar else "climate"
    suffix = "_tripolar" if tripolar else "_climate"
    entries += [
        entry("zslab_tendencies" + suffix, "zslab_tendencies.cu",
              "gb25_tpu/ops/pallas_zslab.py:275", path, launches["K1"], k1c,
              k1_bound(cfg, grid, 3, True)),
        entry("barotropic_loop_fold" if tripolar else "barotropic_loop_masked",
              "barotropic_loop.cu", "gb25_tpu/ops/pallas_barotropic.py:94", path,
              launches["K2"], k2m, k2_bound(grid, substeps, True)),
    ]
    entries[-1].update(bitwise=k2m["bitwise"], l2=k2m["l2"])
    entries[0].update(on_device(loop_rec, "K1"))
    entries[1].update(on_device(loop_rec, "K2"))
    if not tripolar:
        k3_entry = entry("implicit_diffusion", "implicit_diffusion.cu",
                         "gb25_tpu/ops/pallas_tridiag.py:87", path, launches["K3"], k3,
                         (k3["bound_ms"], "bytes"))
        k3_entry.update(per_solve_ms=k3["per_solve_ms"], per_solve_launch=k3["per_solve_launch"],
                        **on_device(loop_rec, "K3"))
        entries += [k3_entry,
                    entry("catke_diffusivities", "catke_diffusivities.cu",
                          "gb25_tpu/ops/pallas_catke.py:64", path, launches["K4"], k4,
                          k4_bound(grid))]
        entries[-1].update(on_device(loop_rec, "K4"))
    return entries, {"ms_step": ms_step, "rate": rate, "plain_ms_step": plain_ms_step,
                     "host_ms_step": host_ms, "loop": loop_rec}


# --------------------------------------------------------------------------
# the flagship with the k-epsilon closure
# --------------------------------------------------------------------------

def phase_k4_keps(cfg, grid, ue, ve, be, ee, epse):
    """K4's k-epsilon function against its plain version: bit for bit (the
    same formulas in the same order, -fmad=false)."""
    from gb25_tpu_torch.ops import pallas_catke

    got = pallas_catke.keps_diffusivities_kernel(cfg, grid, ue, ve, be, ee, epse)
    want = pallas_catke.keps_diffusivities_plain(cfg.closure, grid, ue, ve, be, ee, epse)
    torch.cuda.synchronize()
    names = ("kappa_u", "kappa_c", "kappa_e", "kappa_eps", "G_e", "G_eps")
    errs = [compare(n, g, w, 0.0, 0.0) for n, g, w in zip(names, got, want)]
    ms = cuda_time_ms(lambda: pallas_catke.keps_diffusivities_kernel(cfg, grid, ue, ve, be, ee,
                                                                     epse), reps=10)
    plain_ms = cuda_time_ms(lambda: pallas_catke.keps_diffusivities_plain(
        cfg.closure, grid, ue, ve, be, ee, epse), reps=3)
    print(f"  K4 k-epsilon {ms:.3f} ms; plain {plain_ms:.3f} ms")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}, got


def keps_operands(grid, state, gen):
    """Extended k-epsilon fields: currents of ~0.05 m/s, a T perturbation
    (both signs of N^2), e and eps around the start state."""
    from gb25_tpu_torch.ops.halos import extend_field

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=DEVICE)

    ue = extend_field(grid, noise(0.05), "u")
    ve = extend_field(grid, noise(0.05), "v")
    tr = {"T": state.tracers["T"] + noise(0.1), "S": state.tracers["S"],
          "e": 1e-5 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE)),
          "eps": 1e-8 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE))}
    return ue, ve, {k: extend_field(grid, c, "c") for k, c in tr.items()}


def keps(card):
    """The flagship with the k-epsilon closure: phases [15] to [18]."""
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops import (
        pallas_barotropic,
        pallas_catke,
        pallas_tridiag,
        pallas_zslab,
    )

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                    closure=TKEDissipationVerticalDiffusivity())
    assert tuple(state.tracers) == ("T", "S", "e", "eps")
    gen = torch.Generator(device=DEVICE).manual_seed(2468)

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=DEVICE)

    ue, ve, tr_e = keps_operands(grid, state, gen)
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    print(f"[15] K4 k-epsilon vs plain at {NX}x{NY}x{NZ}, bit for bit")
    k4, diffs = phase_k4_keps(cfg, grid, ue, ve, be, tr_e["e"], tr_e["eps"])
    print("[16] K1 four-tracer instance vs plain")
    Gv_p = noise(1e-7)
    Gv_p[:, 0, :] = 0.0
    prev = (noise(1e-7), Gv_p, {k: noise(1e-7) for k in tr_e})
    k1 = phase_k1_instance(cfg, grid, ue, ve, tr_e, be, b_total, prev, "four-tracer")
    del prev, be, b_total
    print("[17] K3 vs plain: the (u, v), (T, S), e and eps solves of a k-epsilon step")
    ku, kc, ke, keps_, _, _ = diffs

    def inner(t):
        return grid.interior(t).contiguous()

    k3 = phase_k3(cfg, grid, {"u,v": ((inner(ue), inner(ve)), ku, None),
                              "T,S": ((inner(tr_e["T"]), inner(tr_e["S"])), kc, None),
                              "e": ((inner(tr_e["e"]),), ke, None),
                              "eps": ((inner(tr_e["eps"]),), keps_, None)})
    del diffs, ku, kc, ke, keps_, ue, ve, tr_e

    print("[18] k-epsilon main path: one step kernels='auto' vs 'torch'")
    cfg_plain = dataclasses.replace(cfg, kernels="torch")
    phase_step_compare(lambda s: time_step(cfg, grid, s, DT),
                       lambda s: time_step(cfg_plain, grid, s, DT), state)
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K3": pallas_tridiag.KERNEL, "K4_keps": pallas_catke.KEPS_KERNEL,
               "K4": pallas_catke.KERNEL}
    per_step = {"K1": 1, "K2": 1, "K3": 4, "K4_keps": 1, "K4": 0}
    step_n = lambda st, n: loop(cfg, grid, st, DT, n)  # noqa: E731
    s, elapsed, launches, _, loop_rec = run_main_path(step_n, state, kernels, per_step,
                                                      KEPS_STEPS)
    umax = check_state(s, (NZ, NY, NX))
    e_min, eps_min = float(s.tracers["e"].min()), float(s.tracers["eps"].min())
    if e_min < 0.0 or eps_min < 0.0:
        raise AssertionError(f"e or eps < 0 after the run: {e_min}, {eps_min}")
    print(f"  max|u| {umax:.4f} m/s; e in [{e_min:.3e}, {float(s.tracers['e'].max()):.3e}], "
          f"eps in [{eps_min:.3e}, {float(s.tracers['eps'].max()):.3e}]")
    ms_step = 1e3 * elapsed / KEPS_STEPS
    rate = NX * NY * NZ * KEPS_STEPS / elapsed
    host_ms = loop_vs_host("k-epsilon", step_n, host_steps(
        lambda st: time_step(cfg, grid, st, DT, premasked=True), grid), s, ms_step)
    del s
    sp, plain_elapsed = timed_loop(lambda st, n: loop(cfg_plain, grid, st, DT, n), state, 0,
                                   KEPS_PLAIN_STEPS)
    check_state(sp, (NZ, NY, NX))
    plain_ms_step = 1e3 * plain_elapsed / KEPS_PLAIN_STEPS
    print(f"  k-epsilon flagship {NX}x{NY}x{NZ} f32 on {card}: {ms_step:.3f} ms/step, "
          f"{rate:.4e} cell-steps/s, timed second {KEPS_STEPS}-step loop, replayed; launched "
          f"from the host {host_ms:.3f} ms/step; plain torch {plain_ms_step:.3f} ms/step")

    path = "keps"
    k3_entry = entry("implicit_diffusion_keps", "implicit_diffusion.cu",
                     "gb25_tpu/ops/pallas_tridiag.py:87", path, launches["K3"], k3,
                     (k3["bound_ms"], "bytes"))
    k3_entry.update(per_solve_ms=k3["per_solve_ms"], per_solve_launch=k3["per_solve_launch"],
                    **on_device(loop_rec, "K3"))
    return [
        entry("zslab_tendencies_keps", "zslab_tendencies.cu", "gb25_tpu/ops/pallas_zslab.py:275",
              path, launches["K1"], k1, k1_bound(cfg, grid, 4, False)) | on_device(loop_rec, "K1"),
        k3_entry,
        entry("keps_diffusivities", "keps_diffusivities.cu", "gb25_tpu/ops/pallas_catke.py:228",
              path, launches["K4_keps"], k4, k4_keps_bound(grid)) | on_device(loop_rec, "K4_keps"),
    ], {"ms_step": ms_step, "rate": rate, "plain_ms_step": plain_ms_step,
        "host_ms_step": host_ms, "loop": loop_rec}


# --------------------------------------------------------------------------
# the decomposed path on one card: kernel K5, the forced 1x1 modes
# --------------------------------------------------------------------------

def k5_bound(Ye, Xe, substeps, metric2d, masked):
    """One block reads eta, U, V, the four forcing planes, dyc, dxf and
    dtau / area (planes on the tripolar grid, columns otherwise) and the
    two masks, and writes six planes; 14 (16 masked) operations per cell and
    substep, the Pallas kernel's own count."""
    plane = Ye * Xe * 4
    nbytes = (7 + 6 + (3 if metric2d else 0) + (2 if masked else 0)) * plane
    nbytes += 0 if metric2d else 3 * Ye * 4
    return bound(nbytes, (16 if masked else 14) * substeps * Ye * Xe)


def phase_k5(gen):
    """K5 against its plain version at the decomposed climate shape: one
    block of 30 substeps (W = 30) on (768 + 60) x (1536 + 60) planes, with
    tripolar metric planes and masks, then with lat-lon metric columns."""
    from gb25_tpu_torch.models.free_surface import averaging_weights
    from gb25_tpu_torch.ops import pallas_barotropic
    from gb25_tpu_torch.utils.profiling import queued_device_ms

    W = DECOMPOSED_W
    Ye, Xe = NY + 2 * W, NX + 2 * W
    weights = averaging_weights(W)
    n_launch = -(-W // pallas_barotropic.substeps_per_launch())

    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=DEVICE)

    out = {}
    for label, metric2d, masked in (("tripolar", True, True), ("columns", False, False)):
        m = (Ye, Xe) if metric2d else (Ye, 1)
        # a real block's magnitudes: dtau = 4 s, ~4000 m deep, ~27 km cells
        ops = [r((Ye, Xe), 2e-2, -1e-2), r((Ye, Xe), 2.0, -1.0), r((Ye, Xe), 2.0, -1.0),
               r((Ye, Xe), 1.0, 5.0), r((Ye, Xe), 1.0, 5.0), r((Ye, Xe), 2e-4, -1e-4),
               r((Ye, Xe), 2e-4, -1e-4), r(m, 5e3, 2.5e4), r(m, 5e3, 2.5e4), r(m, 1e-9, 5e-9)]
        masks = ([(r((Ye, Xe), 1.0) > 0.05).float() for _ in range(2)] if masked
                 else [None, None])

        def kernel():
            return pallas_barotropic._barotropic_block_cuda(weights, *ops, *masks)

        def plain():
            return pallas_barotropic.barotropic_block_plain(weights, *ops, *masks)

        got, want = check_k5_launches(kernel, n_launch), plain()
        torch.cuda.synchronize()
        names = ("eta", "U", "V", "pe", "pU", "pV")
        errs = [compare(f"{n} {label}", g, w, 0.0, 0.0)  # bit for bit
                for n, g, w in zip(names, got, want)]
        del got, want
        ms = cuda_time_ms(kernel, reps=10)
        device_ms = queued_device_ms(kernel, reps=10)
        plain_ms = cuda_time_ms(plain, reps=3)
        b = k5_bound(Ye, Xe, W, metric2d, masked)
        info = pallas_barotropic.block_info(masked, metric2d)
        print(f"  K5 {label} ({Ye}x{Xe}, {W} substeps in {n_launch} launches): {ms:.3f} ms "
              f"(queued behind a sleep, the device alone: {device_ms:.3f}); plain "
              f"{plain_ms:.3f} ms; bit for bit; " + launch_line(info, b)
              + f", {info['substeps']} substeps a launch")
        out[label] = {"max_abs_err": max(errs), "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound": b, "bitwise": True, "launch": info}
        del ops, masks
    return out


def check_k5_launches(run, want):
    """``run()``'s outputs; raise unless it made exactly ``want`` K5
    launches."""
    from gb25_tpu_torch.ops import pallas_barotropic

    before = pallas_barotropic.BLOCK_KERNEL.launches
    out = run()
    made = pallas_barotropic.BLOCK_KERNEL.launches - before
    if made != want:
        raise AssertionError(f"K5 made {made} launches for a block, expected {want}")
    return out


def k5_per_step(cfg, grid):
    """K5's launches in one step of ``cfg``'s blocked solve on ``grid``."""
    from gb25_tpu_torch.models.free_surface import exchange_width
    from gb25_tpu_torch.ops import pallas_barotropic

    fs = cfg.free_surface
    return pallas_barotropic.step_launches(fs.substeps, exchange_width(fs, grid))


@contextlib.contextmanager
def no_collectives():
    """Fail on any torch.distributed exchange or collective while the
    block runs: the forced 1x1 mesh's "ring" sits on an NCCL group of one
    rank whose exchanges are copies of the tile's own strips, so its
    replayed loop must call none (``parallel.mesh.post`` also refuses an
    exchange under a capture)."""
    names = ("batch_isend_irecv", "isend", "irecv", "send", "recv", "all_gather", "all_reduce",
             "broadcast")
    saved = {n: getattr(dist, n) for n in names}

    def refuse(name):
        def call(*args, **kwargs):
            raise AssertionError(f"torch.distributed.{name} called on the forced 1x1 mesh")
        return call

    for n in names:
        setattr(dist, n, refuse(n))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def decomposed(label, build, state, serial_ms, kernels, per_step, steps, phase,
               compare=None, modes=("local", "ring")):
    """A model forced onto the decomposed path on a 1x1 mesh:
    ``build(mode, plain)`` gives the rank's step function ``fn(state, dt,
    n=None)``, built once per mode (its tile grid keeps the loop's captured
    graph; ``fn.step`` is its one step, for the host loop). After
    ``WARMUP`` steps one step of the kernel path against the plain path
    (``compare(fn, plain_fn, state)``, by default [5]'s tolerances),
    "ring" against "local" bit for bit over one step; then for each of
    ``modes`` the main path (launch counts per step held to ``per_step``,
    the profiler probe), timed, and the replayed loop against the host loop
    bit for bit; "ring" with every torch.distributed call
    refused. Returns each mode's ms/step (replayed, from the host), launch
    counts, the loop's record and its final state."""
    print(f"[{phase}] decomposed 1x1 {label} (W = {DECOMPOSED_W}): {WARMUP} steps, then one "
          "step against 'torch', and 'ring' vs 'local'")
    fn = build("local", False)
    moved = fn(state, DT, WARMUP)
    plain_fn = build("local", True)
    if compare is None:
        phase_step_compare(lambda s: fn(s, DT), lambda s: plain_fn(s, DT), moved)
    else:
        compare(fn, plain_fn, moved)
    with no_collectives():
        a, b = fn(moved, DT), build("ring", False)(moved, DT)
    fields = {"u": (a.u, b.u), "v": (a.v, b.v), "eta": (a.eta, b.eta),
              **{k: (a.tracers[k], b.tracers[k]) for k in a.tracers}}
    differ = [name for name, (x, y) in fields.items() if not torch.equal(x, y)]
    if differ:
        raise AssertionError(f"'ring' differs from 'local' in {differ}")
    print(f"  'ring' equals 'local' bit for bit over one step ({', '.join(fields)})")
    del fn, plain_fn, moved, a, b, fields
    res = {}
    for mode in modes:
        print(f"  mode {mode!r}:")
        fn = build(mode, False)
        step_n = lambda st, n: fn(st, DT, n)  # noqa: E731
        with no_collectives() if mode == "ring" else contextlib.nullcontext():
            s, elapsed, launches, peak_gb, rec = run_main_path(step_n, state, kernels, per_step,
                                                               steps)
            ms_step = 1e3 * elapsed / steps
            host_ms = loop_vs_host(f"decomposed 1x1 {label} {mode}", step_n,
                                   host_steps(functools.partial(fn.step, dt=DT), fn.grid), s,
                                   ms_step)
        if rec["replays"] == 0:
            raise AssertionError(f"decomposed 1x1 {label} {mode}: the loop replayed no graph")
        res[mode] = {"ms_step": ms_step, "host_ms_step": host_ms, "launches": launches,
                     "loop": rec, "peak_gb": peak_gb, "state": s}
        del fn, step_n, s
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  decomposed 1x1 {label} {NX}x{NY}x{NZ} f32, replayed: " + ", ".join(
        f"{m} {r['ms_step']:.3f} ms/step (from the host {r['host_ms_step']:.3f})"
        for m, r in res.items()) + f" ({WARMUP} + {steps} + {steps} steps, the second {steps} "
        f"timed); serial route {serial_ms:.3f} ms/step in this call")
    return res


def tripolar_decomposed_model(kernels="auto"):
    """The bench's climate_quarter_sharded1x1 row: the tripolar climate model
    at 1/4 degree with exchange_width = 30, and ``build(mode, plain)``
    giving its forced-1x1 step function."""
    from gb25_tpu_torch import data_free_ocean_climate_model
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.parallel import make_mesh, sharded_coupled_step_fn

    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=RESOLUTION, Nz=NZ, device=DEVICE, grid_type="gaussian_islands_tripolar",
        kernels=kernels)
    fs = SplitExplicitFreeSurface(exchange_width=DECOMPOSED_W)
    ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, free_surface=fs))
    plain = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean, kernels="torch"))
    mesh = make_mesh()

    def build(mode, use_plain):
        return sharded_coupled_step_fn(plain if use_plain else ccfg, grid, atmos, mesh,
                                       force_comm=mode)

    return ccfg, grid, state, build


def decomposed_climate(card, serial_ms, phase):
    """[20]: the tripolar climate model forced onto the 1x1 mesh."""
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_catke, pallas_tridiag, pallas_zslab

    ccfg, grid, state, build = tripolar_decomposed_model()
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K5": pallas_barotropic.BLOCK_KERNEL, "K3": pallas_tridiag.KERNEL,
               "K4": pallas_catke.KERNEL}
    per_step = {"K1": 1, "K2": 0, "K5": k5_per_step(ccfg.ocean, grid), "K3": 3, "K4": 1}
    res = decomposed("tripolar climate", build, state, serial_ms, kernels, per_step,
                     DECOMPOSED_STEPS, phase)
    for mode in res:
        print(f"  mode {mode!r}:")
        check_climate_state(res[mode].pop("state"), grid)
    print(f"  on {card}")
    return res


def flagship_decomposed_model(**choices):
    """The bench's sharded1x1 row: the flagship with exchange_width = 30
    (``choices``: the model's further keywords and ``compute_dtype``; the
    explicit free surface keeps its own), and ``build(mode, plain)`` giving
    its forced-1x1 step function."""
    from gb25_tpu_torch import baroclinic_instability_model
    from gb25_tpu_torch.models.config import ExplicitFreeSurface, SplitExplicitFreeSurface
    from gb25_tpu_torch.parallel import make_mesh, sharded_step_fn

    compute_dtype = choices.pop("compute_dtype", None)
    shape = choices.pop("shape", (NX, NY, NZ))
    cfg, grid, state = baroclinic_instability_model(*shape, device=DEVICE, **choices)
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if not isinstance(cfg.free_surface, ExplicitFreeSurface):
        cfg = dataclasses.replace(cfg, free_surface=SplitExplicitFreeSurface(
            exchange_width=DECOMPOSED_W))
    plain = dataclasses.replace(cfg, kernels="torch")
    mesh = make_mesh()

    def build(mode, use_plain):
        return sharded_step_fn(plain if use_plain else cfg, grid, mesh, force_comm=mode)

    return cfg, grid, state, build


def decomposed_flagship(card, serial_ms, phase):
    """[21]: the flagship forced onto the 1x1 mesh."""
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab

    cfg, grid, state, build = flagship_decomposed_model()
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K5": pallas_barotropic.BLOCK_KERNEL}
    per_step = {"K1": 1, "K2": 0, "K5": k5_per_step(cfg, grid)}
    res = decomposed("flagship", build, state, serial_ms, kernels, per_step,
                     DECOMPOSED_STEPS, phase)
    for mode in res:
        check_state(res[mode].pop("state"), (NZ, NY, NX))
    print(f"  on {card}")
    return res


# --------------------------------------------------------------------------
# the K6 route: kernels="pallas"
# --------------------------------------------------------------------------

def phase_k6(cfg, grid, ue, ve, tr_e, label):
    """K6 against its plain version on one instance's operands: the one
    launch and the split pair at K1's tolerances, each bit for bit or not;
    the kernel's TEOS-10 buoyancy against the plain one; the kernel alone
    and the plain version timed."""
    from gb25_tpu_torch.ops import pallas_tendency
    from gb25_tpu_torch.ops.operators import coriolis_ff

    f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
    args = (cfg, grid, f_ff, ue, ve, tr_e)
    got = pallas_tendency.tendency_kernel(*args)
    split = pallas_tendency.pallas_tendencies(*args, split=True)
    want = pallas_tendency.pallas_tendencies_plain(*args)
    torch.cuda.synchronize()
    pairs = [("Gu", got[0], want[0], 1e-9), ("Gv", got[1], want[1], 1e-9)]
    pairs += [("G" + k, got[2][k], want[2][k], 1e-7) for k in tr_e]
    errs = [compare(n, g, w, 2e-4, atol) for n, g, w, atol in pairs]
    bitwise = all(torch.equal(g, w) for _, g, w, _ in pairs)
    split_same = (torch.equal(split[0], got[0]) and torch.equal(split[1], got[1])
                  and all(torch.equal(split[2][k], got[2][k]) for k in tr_e))
    if not split_same:
        raise AssertionError("K6's split launches differ from its single launch")
    if not bitwise:
        raise AssertionError("K6 is not bit for bit with its plain version")
    del got, split, want
    b_kernel = pallas_tendency.teos10_kernel(cfg.eos, tr_e["T"], tr_e["S"], grid.z_c)
    b_plain = cfg.eos.buoyancy(tr_e["T"], tr_e["S"], grid.z_c)
    b_bitwise = torch.equal(b_kernel, b_plain)
    b_err = compare("b", b_kernel, b_plain, 1e-6, 0.0)
    del b_kernel, b_plain
    if not b_bitwise:
        raise AssertionError("K6's TEOS-10 b is not bit for bit with the plain version's")
    ms = cuda_time_ms(lambda: pallas_tendency.tendency_kernel(*args), reps=10)
    plain_ms = cuda_time_ms(lambda: pallas_tendency.pallas_tendencies_plain(*args), reps=3)
    info = pallas_tendency.kernel_info(len(tr_e), "all", grid.north_fold)
    print(f"  K6 {label} instance alone {ms:.3f} ms; plain {plain_ms:.3f} ms; bit for bit with "
          f"the plain version: outputs {bitwise}, TEOS-10 b {b_bitwise} (max abs err "
          f"{b_err:.3e}); split pair equals the single launch; "
          + launch_line(info, k6_bound(cfg, grid, len(tr_e))))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bitwise": bitwise,
            "b_bitwise": b_bitwise, "launch": info}


def cast_state(state, to):
    """``state`` with every tensor moved to ``to``, a dtype or a device."""
    def cast(x):
        return {k: v.to(to) for k, v in x.items()} if isinstance(x, dict) else x.to(to)

    return state.replace(**{f.name: cast(getattr(state, f.name))
                            for f in dataclasses.fields(state) if f.name != "iteration"})


def pressure_ulp_atol(cfg, grid, state):
    """Per-face bounds for Gu and Gv: the gradient of two pressures, each
    4 float32 ulps off, of the largest column total of b dz (~300 m^2/s^2)
    over the face's spacing. K6 and the "torch" route's plain K1 sum that
    total in other orders, and p = csum - total cancels it, so their
    tendencies part by up to this much (on the CPU at 1 and 1/2 degree, up
    to 0.3 of it): ~2e-8 on 28 km cells, more on the tripolar grid's
    smaller fluid cells toward its poles. 0 on solid faces, where both
    routes re-mask G to 0: the pole cells, whose spacings are floored at
    1e-3 of the largest, are land."""
    from gb25_tpu_torch.grids.immersed import interior_masks

    hx, hy, hz = grid.halo
    Nx, Ny, Nz = grid.Nx, grid.Ny, grid.Nz
    b = cfg.eos.buoyancy(state.tracers["T"], state.tracers["S"], grid.z_c[hz : hz + Nz])
    p = float((b * grid.dz_c[hz : hz + Nz]).sum(dim=0).abs().max())
    ulps = 8.0 * torch.finfo(torch.float32).eps * p

    def inner(m):  # (Ny, 1) column or (Ny, Nx) plane
        m = m[0, hy : hy + Ny]
        return m[:, hx : hx + Nx] if m.shape[1] > 1 else m

    au, av = ulps / inner(grid.dxc), ulps / inner(grid.dyf)
    if grid.immersed:
        um, vm = interior_masks(grid)
        return au * um, av * vm
    return au, av


def route_step_compare(cfg, grid, step, plain_step, state, step64=None):
    """One step of the K6 route against one of the "torch" route from
    ``state``: the same physics, formed differently (K6 against K1's plain
    version, the AB2 update and forcing unfused against fused, the blocked
    free surface against K2), so the two part by float32 rounding, which
    two places amplify:
    - the barotropic forcing, the depth integral of G, cancels over depth:
      rounding in either route moves eta, and through the barotropic
      correction u and v, by up to ~1e-3 of their largest values (both
      routes' eta lie 5e-6 to 8e-6 from the float64 step's, of a largest
      1e-2, on the flagship); those three are held at rtol 1e-3 and an
      atol of 1e-3 of their largest value;
    - Gu and Gv carry the pressure gradient of one ulp of p over the cell
      on fluid faces (``pressure_ulp_atol``), their atol where it exceeds
      [5]'s; solid faces are held at [5]'s.
    The tracers and their G are held at [5]'s tolerances. ``step64`` (the
    "torch" step in float64, on the state cast) shows how far each route's
    u, v, eta, Gu and Gv lie from float64."""
    atol_u, atol_v = pressure_ulp_atol(cfg, grid, state)
    a, b = step(state), plain_step(state)
    barotropic = {"u": (a.u, b.u), "v": (a.v, b.v), "eta": (a.eta, b.eta)}
    for name, (x, y) in barotropic.items():
        compare(name, x, y, 1e-3, 1e-3 * float(y.abs().max()))
    momentum = {"Gu": (a.Gu, b.Gu), "Gv": (a.Gv, b.Gv)}
    for (name, (x, y)), atol in zip(momentum.items(), (atol_u, atol_v)):
        compare(name, x, y, 1e-3, atol.clamp(min=min(5e-6, 1e-3 * float(y.abs().max()))))
    rest = {**{k: (a.tracers[k], b.tracers[k]) for k in a.tracers},
            **{"G" + k: (a.Gtracers[k], b.Gtracers[k]) for k in a.Gtracers}}
    for name, (x, y) in rest.items():
        compare(name, x, y, 1e-3, min(5e-6, 1e-3 * float(y.abs().max())))
    if step64 is not None:
        c = step64(cast_state(state, torch.float64))
        for name, (x, y) in {**barotropic, **momentum}.items():
            z = getattr(c, name)
            print(f"  {name} against the float64 'torch' step (max {float(z.abs().max()):.4e}): "
                  f"K6 route {float((x.double() - z).abs().max()):.3e}, 'torch' route "
                  f"{float((y.double() - z).abs().max()):.3e}")


def k6_kernels():
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_tendency, pallas_zslab

    return {"K6": pallas_tendency.KERNEL, "K5": pallas_barotropic.BLOCK_KERNEL,
            "K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}


def capture_k5_blocks(run_step):
    """Run ``run_step()`` with ``free_surface.barotropic_block`` wrapped and
    return the operands of its first block and of its last, shorter one,
    each as (weights, operands)."""
    from gb25_tpu_torch.models import free_surface

    wrapped = free_surface.barotropic_block
    blocks = []

    def spy(cfg, weights, *ops):
        blocks[1:] = [(weights, ops)]
        return wrapped(cfg, weights, *ops)

    free_surface.barotropic_block = spy
    try:
        run_step()
    finally:
        free_surface.barotropic_block = wrapped
    return blocks


def phase_k5_route(blocks, label):
    """K5 against its plain version on the operands of a K6-route step's
    blocks (W = 4: seven blocks of 4 substeps and one of 2), at [19]'s
    rtol, bit for bit or not; each block alone and its plain version timed.
    Returns each block's record by its substep count."""
    from gb25_tpu_torch.ops import pallas_barotropic

    out = {}
    s = pallas_barotropic.substeps_per_launch()
    for weights, ops in blocks:
        n = len(weights)

        def kernel():
            return pallas_barotropic._barotropic_block_cuda(weights, *ops)

        def plain():
            return pallas_barotropic.barotropic_block_plain(weights, *ops)

        got, want = check_k5_launches(kernel, -(-n // s)), plain()
        torch.cuda.synchronize()
        names = ("eta", "U", "V", "pe", "pU", "pV")
        errs = [compare(f"{name} {n}", g, w, 0.0, 0.0)  # bit for bit
                for name, g, w in zip(names, got, want)]
        del got, want
        ms = cuda_time_ms(kernel, reps=20)
        plain_ms = cuda_time_ms(plain, reps=5)
        Ye, Xe = ops[0].shape
        b = k5_bound(Ye, Xe, n, ops[7].shape[1] > 1, ops[-1] is not None)
        print(f"  K5 {label} block of {n} substeps ({Ye}x{Xe}) in {-(-n // s)} launch(es): "
              f"{ms:.3f} ms (bound {b[0]:.4f} ms, {b[1]}); plain {plain_ms:.3f} ms; bit for bit")
        out[str(n)] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b[0], "bound_by": b[1], "bitwise": True,
                       "launches": -(-n // s)}
    return out


def k6_keps_route(card, serial_ms):
    """[22], its four-tracer instance on the k-epsilon operands, then the
    k-epsilon flagship on the K6 route, briefly, for that instance's
    launches."""
    from gb25_tpu_torch import baroclinic_instability_model, loop
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops import pallas_catke, pallas_tridiag

    cfg, grid, state = baroclinic_instability_model(
        NX, NY, NZ, device=DEVICE, kernels="pallas", closure=TKEDissipationVerticalDiffusivity())
    ue, ve, tr_e = keps_operands(grid, state, torch.Generator(device=DEVICE).manual_seed(2468))
    res = phase_k6(cfg, grid, ue, ve, tr_e, "four-tracer")
    del ue, ve, tr_e
    print(f"  k-epsilon flagship on the K6 route, {WARMUP} + 2x{K6_KEPS_STEPS} steps:")
    kernels = {**k6_kernels(), "K3": pallas_tridiag.KERNEL, "K4_keps": pallas_catke.KEPS_KERNEL}
    per_step = {"K6": 1, "K5": k5_per_step(cfg, grid), "K1": 0, "K2": 0, "K3": 4,
                "K4_keps": 1}
    s, elapsed, launches, _, loop_rec = run_main_path(
        lambda st, n: loop(cfg, grid, st, DT, n), state, kernels, per_step, K6_KEPS_STEPS)
    check_state(s, (NZ, NY, NX))
    if float(s.tracers["e"].min()) < 0.0 or float(s.tracers["eps"].min()) < 0.0:
        raise AssertionError("e or eps < 0 after the K6-route run")
    ms_step = 1e3 * elapsed / K6_KEPS_STEPS
    print(f"  k-epsilon flagship, K6 route, on {card}: {ms_step:.3f} ms/step (timed second "
          f"{K6_KEPS_STEPS}-step loop, replayed); K1 route [18] {serial_ms:.3f} ms/step")
    return res, launches, ms_step, k6_bound(cfg, grid, 4), None, loop_rec, None


def flagship_k6_model():
    from gb25_tpu_torch import baroclinic_instability_model

    return baroclinic_instability_model(NX, NY, NZ, device=DEVICE, kernels="pallas")


def tripolar_k6_model():
    from gb25_tpu_torch import data_free_ocean_climate_model

    return data_free_ocean_climate_model(resolution=RESOLUTION, Nz=NZ, device=DEVICE,
                                         grid_type="gaussian_islands_tripolar", kernels="pallas")


def k6_instances():
    """[22], its flagship instance on the flagship's state and its
    tripolar instance on the climate operands of [12]."""
    from gb25_tpu_torch.ops.halos import extend_field

    cfg, grid, state = flagship_k6_model()
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    flag = phase_k6(cfg, grid, ue, ve, tr_e, "flagship"), k6_bound(cfg, grid, 2)
    del cfg, grid, state, ue, ve, tr_e
    torch.cuda.empty_cache()
    ccfg, grid, _, state = tripolar_k6_model()
    ue, ve, tr_e = climate_operands(ccfg.ocean, grid, state,
                                    torch.Generator(device=DEVICE).manual_seed(4321))[:3]
    trip = phase_k6(ccfg.ocean, grid, ue, ve, tr_e, "tripolar"), k6_bound(ccfg.ocean, grid, 3)
    return flag, trip


def k6_flagship(card, serial_ms):
    """[23]: the flagship on the K6 route."""
    from gb25_tpu_torch import loop, time_step

    from gb25_tpu_torch import baroclinic_instability_model

    cfg, grid, state = flagship_k6_model()
    print("[23] flagship on the K6 route: one step kernels='pallas' vs 'torch'")
    cfg_torch = dataclasses.replace(cfg, kernels="torch")
    grid64 = baroclinic_instability_model(NX, NY, NZ, device=DEVICE, dtype=torch.float64)[1]
    route_step_compare(cfg, grid, lambda s: time_step(cfg, grid, s, DT),
                       lambda s: time_step(cfg_torch, grid, s, DT), state,
                       lambda s: time_step(cfg_torch, grid64, s, DT))
    del grid64
    torch.cuda.empty_cache()
    per_step = {"K6": 1, "K5": k5_per_step(cfg, grid), "K1": 0, "K2": 0}
    step_n = lambda st, n: loop(cfg, grid, st, DT, n)  # noqa: E731
    s, elapsed, launches, _, loop_rec = run_main_path(step_n, state, k6_kernels(), per_step,
                                                      STEPS)
    umax = check_state(s, (NZ, NY, NX))
    ms_step = 1e3 * elapsed / STEPS
    host_ms = loop_vs_host("flagship, K6 route", step_n, host_steps(
        lambda st: time_step(cfg, grid, st, DT, premasked=True), grid), s, ms_step)
    print(f"  flagship {NX}x{NY}x{NZ} f32, K6 route, on {card}: {ms_step:.3f} ms/step "
          f"({NX * NY * NZ * STEPS / elapsed:.4e} cell-steps/s, timed second {STEPS}-step loop, "
          f"replayed, max|u| {umax:.4f} m/s); launched from the host {host_ms:.3f} ms/step; K1 "
          f"route [5] {serial_ms:.3f} ms/step")
    print("  K5 on the operands of one more step's first and last blocks (metric columns):")
    k5 = phase_k5_route(capture_k5_blocks(lambda: time_step(cfg, grid, s, DT)), "flagship")
    return launches, ms_step, k5, loop_rec, host_ms


def k6_tripolar(card, serial_ms):
    """[24]: the tripolar climate on the K6 route."""
    from gb25_tpu_torch import coupled_loop, coupled_time_step, data_free_ocean_climate_model
    from gb25_tpu_torch.ops import pallas_catke, pallas_tridiag

    ccfg, grid, atmos, state = tripolar_k6_model()
    cfg = ccfg.ocean
    print(f"[24] tripolar climate on the K6 route: {WARMUP} coupled steps, then one step "
          "kernels='pallas' vs 'torch'")
    plain = dataclasses.replace(ccfg, ocean=dataclasses.replace(cfg, kernels="torch"))
    moved = coupled_loop(ccfg, grid, atmos, state, DT, WARMUP)
    c64, grid64, atmos64, _ = data_free_ocean_climate_model(
        resolution=RESOLUTION, Nz=NZ, device=DEVICE, dtype=torch.float64,
        grid_type="gaussian_islands_tripolar", kernels="torch")
    route_step_compare(cfg, grid, lambda s: coupled_time_step(ccfg, grid, atmos, s, DT),
                       lambda s: coupled_time_step(plain, grid, atmos, s, DT), moved,
                       lambda s: coupled_time_step(c64, grid64, atmos64, s, DT))
    del moved, c64, grid64, atmos64
    torch.cuda.empty_cache()
    kernels = {**k6_kernels(), "K3": pallas_tridiag.KERNEL, "K4": pallas_catke.KERNEL}
    per_step = {"K6": 1, "K5": k5_per_step(cfg, grid), "K1": 0, "K2": 0, "K3": 3, "K4": 1}
    step_n = lambda st, n: coupled_loop(ccfg, grid, atmos, st, DT, n)  # noqa: E731
    s, elapsed, launches, _, loop_rec = run_main_path(step_n, state, kernels, per_step,
                                                      K6_CLIMATE_STEPS)
    check_climate_state(s, grid)
    ms_step = 1e3 * elapsed / K6_CLIMATE_STEPS
    host_ms = loop_vs_host("tripolar climate, K6 route", step_n, host_steps(
        lambda st: coupled_time_step(ccfg, grid, atmos, st, DT, premasked=True), grid), s,
        ms_step)
    print(f"  tripolar climate {NX}x{NY}x{NZ} f32, K6 route, on {card}: {ms_step:.3f} ms/step "
          f"(timed second {K6_CLIMATE_STEPS}-step loop, replayed); launched from the host "
          f"{host_ms:.3f} ms/step; K1 route [13] {serial_ms:.3f} ms/step")
    print("  K5 on the operands of one more step's first and last blocks (metric planes, "
          "masks):")
    k5 = phase_k5_route(
        capture_k5_blocks(lambda: coupled_time_step(ccfg, grid, atmos, s, DT)), "tripolar")
    return launches, ms_step, k5, loop_rec, host_ms


def k6_phases(card, serial):
    """Phases [22] to [24]; ``serial``: the K1 route's ms/step of each
    model in this run. Returns K6's kernel entries, K5 on the K6 routes
    (its launches there and, on the flagship and tripolar routes, its
    checks and times on real blocks) and the routes' ms/step."""
    print(f"[22] K6 (pallas_tendencies) vs plain at {NX}x{NY}x{NZ}: flagship, tripolar and "
          "four-tracer instances")
    (flag_res, flag_b), (trip_res, trip_b) = k6_instances()
    torch.cuda.empty_cache()
    kk = k6_keps_route(card, serial["keps"])
    torch.cuda.empty_cache()
    launches, ms_step, k5, loop_rec, host_ms = k6_flagship(card, serial["flagship"])
    kf = (flag_res, launches, ms_step, flag_b, k5, loop_rec, host_ms)
    torch.cuda.empty_cache()
    launches, ms_step, k5, loop_rec, host_ms = k6_tripolar(card, serial["climate_tripolar"])
    kt = (trip_res, launches, ms_step, trip_b, k5, loop_rec, host_ms)
    torch.cuda.empty_cache()
    entries, k5_routes, ms = [], {}, {}
    for (res, launches, ms_step, b, k5, loop_rec, host_ms), name, path in (
            (kf, "pallas_tendencies", "flagship_k6"),
            (kt, "pallas_tendencies_tripolar", "climate_tripolar_k6"),
            (kk, "pallas_tendencies_keps", "keps_k6")):
        e = entry(name, "tendencies.cu", "gb25_tpu/ops/pallas_tendency.py:115", path,
                  launches["K6"], res, b)
        e.update(bitwise=res["bitwise"], b_bitwise=res["b_bitwise"], **on_device(loop_rec, "K6"))
        entries.append(e)
        k5_routes[path] = {"launches": launches["K5"], **on_device(loop_rec, "K5")}
        if k5 is not None:
            k5_routes[path]["blocks"] = k5
        ms[path] = {"ms_step": ms_step, "host_ms_step": host_ms, "loop": loop_rec}
    return entries, k5_routes, ms


# --------------------------------------------------------------------------
# the shallow-water model: bench.py --config atmosphere
# --------------------------------------------------------------------------

def sw_mass(grid, h):
    """sum(h azc) over the lat-lon grid's cells, in float64."""
    az = grid.azc[0, grid.hy : grid.hy + grid.Ny, 0].double()
    return float((h.double() * az[:, None]).sum())


def sw_step_vs_f64(cfg, grid, state):
    """One step on the card against the same step on the CPU in float64,
    from the same state (the card's float32 values widened). Tolerance:
    float32 rounding of the Bernoulli potential phi = K + g h (~1e4
    m^2/s^2) differenced over a face, 4 eps32 max|phi| over the face's
    spacing for Gu and Gv, and of the mass flux, 4 eps32 max(h) max|u, v|
    over the cell's least spacing for Gh; for u, v and h those times dt c1
    (c1 = 1.6) plus 4 float32 ulps of the field's largest value; rtol 1e-6
    (the grid's float32 metrics)."""
    from gb25_tpu_torch import shallow_water_model, sw_time_step

    got = sw_time_step(cfg, grid, state, DT)
    cfg64, grid64, _ = shallow_water_model(NX, NY, device="cpu", dtype=torch.float64)
    fields = ("u", "v", "h", "Gu", "Gv", "Gh", "time")
    want = sw_time_step(cfg64, grid64, state.replace(
        **{k: getattr(state, k).to("cpu", torch.float64) for k in fields}), DT)
    eps = torch.finfo(torch.float32).eps
    hy = grid64.hy
    dxc = grid64.dxc[0, hy : hy + NY].to(DEVICE)  # (Ny, 1) rows
    dyf = grid64.dyf[0, hy : hy + NY].to(DEVICE)
    h_max = float(state.h.abs().max())
    vel = max(float(state.u.abs().max()), float(state.v.abs().max()))
    phi = cfg.gravitational_acceleration * h_max + vel**2
    a = {"Gu": 4 * eps * phi / dxc, "Gv": 4 * eps * phi / dyf,
         "Gh": 4 * eps * h_max * vel / torch.minimum(dxc, dyf)}
    for name, g in (("u", "Gu"), ("v", "Gv"), ("h", "Gh")):
        ref = getattr(want, name)
        a[name] = 1.6 * DT * a[g] + 4 * eps * float(ref.abs().max())
    for name, atol in a.items():
        compare(name, getattr(got, name), getattr(want, name).to(DEVICE), 1e-6, atol)
    if float(got.time) != float(want.time) or got.iteration != want.iteration:
        raise AssertionError("the clock differs from the float64 step's")


def shallow_water(card):
    """[25]: the shallow-water model of bench.py --config atmosphere."""
    from gb25_tpu_torch import shallow_water_model, sw_loop, sw_time_step
    from gb25_tpu_torch.models import device_loop

    cfg, grid, state = shallow_water_model(NX, NY, device=DEVICE)
    print(f"[25] shallow water (bench.py --config atmosphere) at {NX}x{NY} f32, dt = {DT:g} s: "
          f"{WARMUP} steps, then one step against the same step on the CPU in float64")
    sw_step_vs_f64(cfg, grid, sw_loop(cfg, grid, state, DT, WARMUP))

    def step(st):
        return sw_time_step(cfg, grid, st, DT)

    def step_n(st, n):
        return sw_loop(cfg, grid, st, DT, n)

    def host_n(st, n):
        return device_loop.host_loop(step, st, n)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    device_loop.STATS.reset()
    s, elapsed = timed_loop(step_n, state, WARMUP, STEPS)
    stats = dataclasses.replace(device_loop.STATS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_steps = WARMUP + 2 * STEPS
    if stats.replays == 0 or stats.eager_steps + stats.replayed_steps != n_steps:
        raise AssertionError(f"the shallow-water loop ran {stats}, expected replays making up "
                             f"{n_steps} steps")
    ms_step = 1e3 * elapsed / STEPS
    for name in ("u", "v", "h"):
        if not torch.isfinite(getattr(s, name)).all():
            raise AssertionError(f"{name} is not finite after the run")
    umax = float(s.u.abs().max())
    if not 0.01 < umax < 10.0:
        raise AssertionError(f"max|u| = {umax} m/s: no sane geostrophic jet")
    m0, m1 = sw_mass(grid, state.h), sw_mass(grid, s.h)
    drift = abs(m1 - m0) / m0
    # each step rounds h + dt Gh to float32: at most eps32 / 2 of the mass
    # a step, were every cell rounded the same way
    if drift > n_steps * torch.finfo(torch.float32).eps:
        raise AssertionError(f"mass drifted by {drift:.3e} of itself over {n_steps} steps")
    print(f"  {n_steps} steps: {stats.eager_steps} eager, {stats.replayed_steps} replayed in "
          f"{stats.replays} replays of {device_loop.BLOCK_STEPS}-step graphs (pools "
          f"{stats.pool_bytes / 1e9:.3f} GB); peak device memory {peak_gb:.3f} GB; max|u| "
          f"{umax:.4f} m/s; mass sum(h azc) drifted by {drift:.3e} of itself (bound "
          f"{n_steps * torch.finfo(torch.float32).eps:.1e}); fields finite")
    host_ms = loop_vs_host("shallow water", step_n, host_n, s, ms_step)
    del s
    _, host_elapsed = timed_loop(host_n, state, WARMUP, STEPS)
    host_ms_step = 1e3 * host_elapsed / STEPS
    rate, host_rate = NX * NY * STEPS / elapsed, NX * NY * STEPS / host_elapsed
    print(f"  shallow water {NX}x{NY} f32 on {card}: replayed {ms_step:.4f} ms/step "
          f"({rate:.4e} cell-steps/s), launched from the host {host_ms_step:.4f} ms/step "
          f"({host_rate:.4e} cell-steps/s), {host_ms_step / ms_step:.2f}x; {WARMUP} + {STEPS} + "
          f"{STEPS} steps each, the second {STEPS} timed (host loop over {device_loop.BLOCK_STEPS} "
          f"steps in the check above: {host_ms:.4f} ms/step)")
    return {"ms_step": ms_step, "rate": rate, "host_ms_step": host_ms_step,
            "host_rate": host_rate, "peak_gb": peak_gb, "pool_gb": stats.pool_bytes / 1e9}



# --------------------------------------------------------------------------
# the serial flagship's further run-script choices: precision modes,
# VerticalScalarDiffusivity, ExplicitFreeSurface
# --------------------------------------------------------------------------

def phase_k1_unfused(cfg, grid, state):
    """[26]: K1's unfused float32 and bf16-storage instances against their
    plain versions on the flagship's extended fields (``state``), rtol
    2e-4; the bf16 instance on operands rounded beforehand bit for bit with
    itself on the raw ones, and apart from the float32 instance; each
    kernel alone and its plain version timed."""
    from gb25_tpu_torch.ops import pallas_zslab as z
    from gb25_tpu_torch.ops.halos import extend_field

    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    be, b_total = z.column_buoyancy(cfg, grid, tr_e)
    out, outputs = {}, {}
    for form, storage in (("unfused", None), ("unfused_bf16", torch.bfloat16)):
        got = z.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=(be, b_total), storage=storage)
        want = z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be, storage=storage)
        torch.cuda.synchronize()
        pairs = [("Gu", got[0], want[0], 1e-9), ("Gv", got[1], want[1], 1e-9)]
        pairs += [("G" + k, got[2][k], want[2][k], 1e-7) for k in tr_e]
        errs = [compare(n, g, w, 2e-4, atol) for n, g, w, atol in pairs]
        if float(got[1][:, 0, :].abs().max()) != 0.0:
            raise AssertionError(f"K1 {form} left Gv nonzero on the south wall row")
        ops = ((ue, ve, tr_e, be, b_total) if storage is None
               else z.bf16_operands(cfg, grid, ue, ve, tr_e))
        ms = cuda_time_ms(lambda: z.zslab_kernel_unfused(cfg, grid, *ops), reps=10)
        plain_ms = cuda_time_ms(lambda: z.zslab_tendencies_plain(
            cfg, grid, ue, ve, tr_e, be=be, storage=storage), reps=3)
        info = z.kernel_info(2, False, False, form)
        b = k1_bound(cfg, grid, 2, False, False, 2 if storage is not None else 4)
        print(f"  K1 {form} instance alone {ms:.3f} ms; plain {plain_ms:.3f} ms; "
              + launch_line(info, b))
        out[form] = {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "launch": info,
                     "bound": b}
        outputs[form] = [got[0], got[1], *got[2].values()]
        del want, ops

    def rt(x):
        return x.to(torch.bfloat16).float()

    pre = z.zslab_tendencies(cfg, grid, rt(ue), rt(ve), {k: rt(c) for k, c in tr_e.items()},
                             storage=torch.bfloat16)
    pre = [pre[0], pre[1], *pre[2].values()]
    if not all(torch.equal(a, b) for a, b in zip(outputs["unfused_bf16"], pre)):
        raise AssertionError("the bf16-storage instance on rounded operands differs from itself "
                             "on the raw ones")
    bite = max(float((a - b).abs().max())
               for a, b in zip(outputs["unfused_bf16"], outputs["unfused"]))
    if bite == 0.0:
        raise AssertionError("the bf16-storage instance equals the float32 one: no rounding")
    print(f"  bf16 storage: bit for bit on operands rounded beforehand; apart from the float32 "
          f"instance by up to {bite:.3e}")
    return out


def fields_of(s):
    return {"u": s.u, "v": s.v, "eta": s.eta, **s.tracers, "Gu": s.Gu, "Gv": s.Gv,
            **{"G" + k: g for k, g in s.Gtracers.items()}}


def precision_distance(label, got, ref, bounded):
    """One step of a precision mode against the float32 step from the same
    state: every field finite; each field's largest and RMS distance over
    the float32 field's largest value printed and, where ``bounded``, held
    to the JAX package's bounds for "bf16s" (tests/test_zslab.py:438-446:
    pointwise 0.5, RMS 0.05)."""
    a, b = fields_of(ref), fields_of(got)
    worst = {}
    for name in a:
        x, y = a[name].double(), b[name].double()
        if not torch.isfinite(y).all():
            raise AssertionError(f"{label}: {name} is not finite")
        scale = float(x.abs().max()) + 1e-30
        pt, rms = float((x - y).abs().max()), float(((x - y) ** 2).mean().sqrt())
        worst[name] = (pt / scale, rms / scale)
        if bounded and (pt > 0.5 * scale or rms > 0.05 * scale):
            raise AssertionError(f"{label}: {name} parts from the float32 step by {pt:.3e} "
                                 f"(RMS {rms:.3e}) of a largest {scale:.3e}")
    print(f"  {label} vs the float32 step, max abs err and RMS err over max|f32|"
          f"{' (bounds 0.5, 0.05)' if bounded else ''}: "
          + ", ".join(f"{k} {p:.2e} {r:.2e}" for k, (p, r) in worst.items()))


def precision_at_test_size(mode):
    """A precision mode held to the float32 step at the size and by the
    protocol of the JAX package's own test of it, on the card: "bf16s" and
    "f32x2" one step from rest at 32x16x8 (tests/test_zslab.py:423-447,
    every field within its bounds); "bfloat16" 10 steps at 32x16x6
    (tests/test_precision.py: u within 0.15 of max|u|, T within 0.3)."""
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step

    if mode != "bfloat16":
        cfg, grid, state = baroclinic_instability_model(32, 16, 8, device=DEVICE)
        precision_distance(f"{mode} at 32x16x8", time_step(
            dataclasses.replace(cfg, compute_dtype=mode), grid, state, DT),
            time_step(cfg, grid, state, DT), bounded=True)
        return
    cfg, grid, state = baroclinic_instability_model(32, 16, 6, device=DEVICE)
    s32 = loop(cfg, grid, state, DT, 10)
    s16 = loop(dataclasses.replace(cfg, compute_dtype=mode), grid, state, DT, 10)
    du = float((s16.u - s32.u).abs().max()) / max(float(s32.u.abs().max()), 1e-6)
    dT = float((s16.tracers["T"] - s32.tracers["T"]).abs().max())
    if not du < 0.15 or not dT < 0.3:
        raise AssertionError(f"bfloat16 at 32x16x6 over 10 steps: u {du:.3e} of max|u| "
                             f"(bound 0.15), T {dT:.3e} (bound 0.3)")
    print(f"  bfloat16 at 32x16x6, 10 steps vs float32: u {du:.3e} of max|u| (bound 0.15), "
          f"T {dT:.3e} (bound 0.3)")


def choice_row(label, cfg, grid, state, kernels, per_step, steps, dt=DT, probe=True,
               host_check=True):
    """A further choice's flagship: one step kernels="auto" against
    kernels="torch" (the tolerances of [5]), then the main path
    (``run_main_path``) and, with ``host_check``, the device loop against
    the host loop; returns the row's record."""
    from gb25_tpu_torch import loop, time_step

    cfg_plain = dataclasses.replace(cfg, kernels="torch")
    phase_step_compare(lambda s: time_step(cfg, grid, s, dt),
                       lambda s: time_step(cfg_plain, grid, s, dt), state)
    step_n = lambda st, n: loop(cfg, grid, st, dt, n)  # noqa: E731
    s, elapsed, launches, peak_gb, rec = run_main_path(step_n, state, kernels, per_step, steps,
                                                       probe)
    umax = check_state(s, grid.shape)
    ms_step = 1e3 * elapsed / steps
    rate = grid.Nx * grid.Ny * grid.Nz * steps / elapsed
    host_ms = None
    if host_check:
        host_ms = loop_vs_host(label, step_n, host_steps(
            lambda st: time_step(cfg, grid, st, dt, premasked=True), grid), s, ms_step)
    print(f"  {label} {grid.Nx}x{grid.Ny}x{grid.Nz} f32 state: {ms_step:.3f} ms/step, "
          f"{rate:.4e} cell-steps/s, timed second {steps}-step loop, replayed"
          + (f"; launched from the host {host_ms:.3f} ms/step" if host_ms else "")
          + f"; max|u| {umax:.4f} m/s; peak device memory {peak_gb:.2f} GB, graph pool "
          f"{rec['pool_gb']:.2f} GB")
    return {"ms_step": ms_step, "rate": rate, "host_ms_step": host_ms, "steps": steps,
            "launches": launches, "loop": rec, "peak_gb": peak_gb, "pool_gb": rec["pool_gb"],
            "shape": [grid.Nx, grid.Ny, grid.Nz], "dt": dt}


def precision_rows(card):
    """[27]: the precision modes on the flagship: "bf16s" (K1's
    bf16-storage instance and K2), "bfloat16" (the cast array path and K2)
    and "f32x2" (the float64 array path and K2, at 768x384x64). Each: held
    to float32 at the size and by the protocol of the JAX package's own
    test of the mode (``precision_at_test_size``); at the row's size one
    step from rest against the float32 step, finite and its distances
    printed (the rounding of b in bf16 storage moves the pressure
    gradient by more as the cells shrink: on the CPU eta's RMS distance
    grew from 0.004 of its largest value at 128x64x16 to 0.023 at
    768x384x16, so the JAX test's bounds hold only at its size); one step
    after 8 float32 steps against the same mode's "torch" step; then the
    main path from there."""
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab

    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    rows = {}
    for mode, steps in PRECISION_STEPS.items():
        t0 = time.perf_counter()
        shape = F32X2_SHAPE if mode == "f32x2" else (NX, NY, NZ)
        cfg32, grid, state = baroclinic_instability_model(*shape, device=DEVICE)
        cfg = dataclasses.replace(cfg32, compute_dtype=mode)
        moved = loop(cfg32, grid, state, DT, WARMUP)
        print(f"  {mode}: held to float32 at the JAX test's size; one step against the "
              f"float32 step; after {WARMUP} float32 steps one against its 'torch' step, then "
              f"{WARMUP} + 2x{steps} steps replayed")
        precision_at_test_size(mode)
        precision_distance(mode, time_step(cfg, grid, state, DT), time_step(cfg32, grid, state, DT),
                           bounded=False)
        kernel = mode == "bf16s"
        rows[mode] = choice_row(mode, cfg, grid, moved, kernels,
                                {"K1": int(kernel), "K2": 1}, steps, probe=kernel,
                                host_check=kernel)
        rows[mode]["wall_s"] = time.perf_counter() - t0
        print(f"  {mode} row on {card}: {rows[mode]['wall_s']:.1f} s")
        del grid, state, moved
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def vertical_scalar(card):
    """[28]: the flagship with VerticalScalarDiffusivity (nu 1e-4, kappa
    1e-5): K1 (the fused flagship instance) against its plain version at
    rtol 2e-4 and K3's constant-kappa pair bit for bit on the operands of
    the state after 8 steps, then one step against "torch" and the main
    path: per step 1 K1, 1 K2, 2 K3."""
    from gb25_tpu_torch import baroclinic_instability_model, loop
    from gb25_tpu_torch.models import VerticalScalarDiffusivity
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_tridiag, pallas_zslab
    from gb25_tpu_torch.ops.halos import extend_field

    t0 = time.perf_counter()
    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                    closure=VerticalScalarDiffusivity())
    moved = loop(cfg, grid, state, DT, WARMUP)
    gen = torch.Generator(device=DEVICE).manual_seed(9753)

    def noise(s):
        return s * torch.randn(grid.shape, generator=gen, device=DEVICE)

    ue = extend_field(grid, moved.u, "u")
    ve = extend_field(grid, moved.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in moved.tracers.items()}
    be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
    Gv_p = noise(1e-7)
    Gv_p[:, 0, :] = 0.0
    prev = (noise(1e-7), Gv_p, {k: noise(1e-7) for k in tr_e})
    k1 = phase_k1_instance(cfg, grid, ue, ve, tr_e, be, b_total, prev, "vertical-scalar")
    del ue, ve, tr_e, be, b_total, prev
    nu, kappa = cfg.closure.nu, cfg.closure.kappa
    k3 = phase_k3(cfg, grid, {"u,v": ((moved.u, moved.v), nu, None),
                              "T,S": ((moved.tracers["T"], moved.tracers["S"]), kappa, None)})
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K3": pallas_tridiag.KERNEL}
    row = choice_row("vertical scalar", cfg, grid, moved, kernels, {"K1": 1, "K2": 1, "K3": 2},
                     CHOICE_STEPS)
    row.update(k1=k1, k3=k3, wall_s=time.perf_counter() - t0)
    print(f"  vertical-scalar phase on {card}: {row['wall_s']:.1f} s")
    return row


def explicit_free_surface(card):
    """[29]: the flagship with ExplicitFreeSurface at dt = EXPLICIT_DT: one
    step against "torch" after 8 steps (K1's unfused float32 instance
    against its plain version inside it), then the main path: per step 1
    K1 (unfused), 0 K2."""
    from gb25_tpu_torch import baroclinic_instability_model, loop
    from gb25_tpu_torch.models import ExplicitFreeSurface
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab

    t0 = time.perf_counter()
    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                    free_surface=ExplicitFreeSurface())
    moved = loop(cfg, grid, state, EXPLICIT_DT, WARMUP)
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    row = choice_row("explicit free surface", cfg, grid, moved, kernels, {"K1": 1, "K2": 0},
                     EXPLICIT_STEPS, dt=EXPLICIT_DT)
    s = loop(cfg, grid, moved, EXPLICIT_DT, 1)
    if not torch.isfinite(s.Geta).all() or float(s.Geta.abs().max()) == 0.0:
        raise AssertionError("G_eta is not finite, or 0, under the explicit free surface")
    row["wall_s"] = time.perf_counter() - t0
    print(f"  explicit-free-surface phase on {card}: {row['wall_s']:.1f} s")
    return row


def further_choices(card, flagship_ms):
    """[26]-[29]; returns their kernel entries and rows."""
    from gb25_tpu_torch import baroclinic_instability_model, loop

    t0 = time.perf_counter()
    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    print(f"[26] K1's unfused instances vs plain at {NX}x{NY}x{NZ}, on the flagship's fields "
          f"after {WARMUP} steps")
    k1u = phase_k1_unfused(cfg, grid, loop(cfg, grid, state, DT, WARMUP))
    del grid, state
    torch.cuda.empty_cache()
    print(f"  [26] {time.perf_counter() - t0:.1f} s")
    print("[27] precision modes of the flagship")
    prec = precision_rows(card)
    print("[28] the flagship with VerticalScalarDiffusivity")
    vsd = vertical_scalar(card)
    torch.cuda.empty_cache()
    print(f"[29] the flagship with ExplicitFreeSurface, dt = {EXPLICIT_DT:g} s")
    expl = explicit_free_surface(card)
    torch.cuda.empty_cache()
    rows = {**prec, "vertical_scalar": vsd, "explicit": expl}
    print("  ms/step beside the float32 flagship's " + f"{flagship_ms:.3f} ([5]): " + "; ".join(
        f"{name} {r['ms_step']:.3f} ({r['rate']:.4e} cell-steps/s)" for name, r in rows.items()))

    def unfused_entry(name, form, path, row):
        r = k1u[form]
        e = entry(name, "zslab_tendencies.cu", "gb25_tpu/ops/pallas_zslab.py:275", path,
                  row["launches"]["K1"], r, r["bound"])
        return e | on_device(row["loop"], "K1")

    k3 = vsd["k3"]
    k3_entry = entry("implicit_diffusion_constant_kappa", "implicit_diffusion.cu",
                     "gb25_tpu/ops/pallas_tridiag.py:87", "vertical_scalar",
                     vsd["launches"]["K3"], k3, (k3["bound_ms"], "bytes"))
    k3_entry.update(per_solve_ms=k3["per_solve_ms"], per_solve_launch=k3["per_solve_launch"],
                    **on_device(vsd["loop"], "K3"))
    entries = [unfused_entry("zslab_tendencies_unfused", "unfused", "explicit", expl),
               unfused_entry("zslab_tendencies_bf16_storage", "unfused_bf16", "bf16s",
                             prec["bf16s"]),
               k3_entry]
    return entries, rows


# --------------------------------------------------------------------------
# the decomposed path brought up to the serial path, and "float32": [31]-[33]
# --------------------------------------------------------------------------

def decomposed_k6(card, serial_ms):
    """[31]: the tripolar climate on the K6 route forced onto the 1x1 mesh
    at W = 30: one step against "torch" on the tile at [24]'s tolerances,
    "ring" against "local" bit for bit, the main path in "local" (per step
    1 K6, ceil(30 / s) K5, 3 K3, 1 K4, 0 K1, 0 K2) and the device loop
    against the host loop; finite fields, land at rest; then K6 against its
    plain version on the operands of one more tile step, timed."""
    from gb25_tpu_torch.ops import pallas_catke, pallas_tridiag

    t0 = time.perf_counter()
    ccfg, grid, state, build = tripolar_decomposed_model(kernels="pallas")
    kernels = {**k6_kernels(), "K3": pallas_tridiag.KERNEL, "K4": pallas_catke.KERNEL}
    per_step = {"K6": 1, "K5": k5_per_step(ccfg.ocean, grid), "K1": 0, "K2": 0, "K3": 3, "K4": 1}

    def compare(fn, plain_fn, moved):
        route_step_compare(ccfg.ocean, fn.grid, lambda s: fn(s, DT), lambda s: plain_fn(s, DT),
                           moved)

    res = decomposed("tripolar climate, K6 route", build, state, serial_ms, kernels,
                     per_step, K6_CLIMATE_STEPS, 31, compare=compare, modes=("local",))
    state = res["local"].pop("state")
    check_climate_state(state, grid)
    fn = build("local", False)
    cfg, tile, ue, ve, tr_e = capture_k6_operands(lambda: fn(state, DT))
    print("  K6 on the tile's own operands (one more step's exchanged extension):")
    res["local"]["k6"] = phase_k6(cfg, tile, ue, ve, tr_e, "tripolar tile")
    res["local"]["k6"]["bound"] = k6_bound(cfg, tile, len(tr_e))
    del fn, state, tile, ue, ve, tr_e
    res["local"]["wall_s"] = time.perf_counter() - t0
    print(f"  [31] on {card}: {res['local']['wall_s']:.1f} s; serial K6 route [24] "
          f"{serial_ms:.3f} ms/step")
    return res["local"]


def capture_k6_operands(run_step):
    """Run ``run_step()`` with the step's K6 call
    (``hydrostatic.pallas_tendencies``) wrapped; return its (cfg, grid, ue,
    ve, tr_e)."""
    from gb25_tpu_torch.models import hydrostatic

    wrapped = hydrostatic.pallas_tendencies
    seen = []

    def spy(cfg, grid, f_ff, ue, ve, tr_e, **kw):
        seen[:] = [(cfg, grid, ue, ve, tr_e)]
        return wrapped(cfg, grid, f_ff, ue, ve, tr_e, **kw)

    hydrostatic.pallas_tendencies = spy
    try:
        run_step()
    finally:
        hydrostatic.pallas_tendencies = wrapped
    return seen[0]


def tile_choices(card, serial):
    """[33]: the further choices and "float32" on the forced 1x1 flagship
    (W = 30 under the split-explicit free surface): each one step against
    its "torch" tile step (the tolerances of [5]), then the main path in
    "local" with its launches per step and the device loop against the host
    loop; the array modes one step each, finite, against the float32 tile
    step (distances printed), with their launches."""
    from gb25_tpu_torch.models import ExplicitFreeSurface, VerticalScalarDiffusivity
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_tridiag, pallas_zslab
    from gb25_tpu_torch.parallel import make_mesh, sharded_step_fn

    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K5": pallas_barotropic.BLOCK_KERNEL, "K3": pallas_tridiag.KERNEL}
    k5 = pallas_barotropic.step_launches(30, DECOMPOSED_W)
    rows = {}
    for name, choice, dt, per_step in (
            ("bf16s", {"compute_dtype": "bf16s"}, DT, {"K1": 1, "K2": 0, "K5": k5, "K3": 0}),
            ("vertical_scalar", {"closure": VerticalScalarDiffusivity()}, DT,
             {"K1": 1, "K2": 0, "K5": k5, "K3": 2}),
            ("explicit", {"free_surface": ExplicitFreeSurface()}, EXPLICIT_DT,
             {"K1": 1, "K2": 0, "K5": 0, "K3": 0}),
            ("float32", {"compute_dtype": "float32"}, DT, {"K1": 1, "K2": 0, "K5": k5, "K3": 0})):
        t0 = time.perf_counter()
        cfg, grid, state, build = flagship_decomposed_model(**choice)
        fn, plain_fn = build("local", False), build("local", True)
        moved = fn(state, dt, WARMUP)
        print(f"  {name} (dt = {dt:g} s): one step against its 'torch' tile step after "
              f"{WARMUP}, then {WARMUP} + 2x{DECOMPOSED_STEPS} steps replayed")
        phase_step_compare(lambda s: fn(s, dt), lambda s: plain_fn(s, dt), moved)
        del plain_fn
        step_n = lambda st, n: fn(st, dt, n)  # noqa: E731
        s, elapsed, launches, peak_gb, rec = run_main_path(step_n, moved, kernels, per_step,
                                                           DECOMPOSED_STEPS)
        check_state(s, (NZ, NY, NX))
        ms_step = 1e3 * elapsed / DECOMPOSED_STEPS
        host_ms = loop_vs_host(f"decomposed 1x1 {name}", step_n,
                               host_steps(functools.partial(fn.step, dt=dt), fn.grid), s,
                               ms_step)
        rows[name] = {"ms_step": ms_step, "host_ms_step": host_ms, "launches": launches,
                      "loop": rec, "peak_gb": peak_gb, "dt": dt,
                      "wall_s": time.perf_counter() - t0}
        print(f"  decomposed 1x1 {name} on {card}: {ms_step:.3f} ms/step replayed, "
              f"{host_ms:.3f} from the host; serial [{serial[name][1]}] "
              f"{serial[name][0]:.3f} ms/step; {rows[name]['wall_s']:.1f} s")
        del fn, step_n, s, moved, state, grid
        gc.collect()
        torch.cuda.empty_cache()
    for mode in ("bfloat16", "float64", "f32x2"):
        t0 = time.perf_counter()
        shape = F32X2_SHAPE if mode == "f32x2" else (NX, NY, NZ)
        cfg, grid, state, build = flagship_decomposed_model(compute_dtype=mode, shape=shape)
        before = {k: kernel.launches for k, kernel in kernels.items()}
        got = build("local", False)(state, DT)
        torch.cuda.synchronize()
        made = {k: kernel.launches - before[k] for k, kernel in kernels.items()}
        if made != {"K1": 0, "K2": 0, "K5": k5, "K3": 0}:
            raise AssertionError(f"{mode} on the tile made {made} launches in one step")
        ref = sharded_step_fn(dataclasses.replace(cfg, compute_dtype=None), grid, make_mesh(),
                              force_comm="local")(state, DT)
        precision_distance(f"{mode} on the tile ({'x'.join(map(str, shape))})", got, ref,
                           bounded=False)
        rows[mode] = {"launches_one_step": made, "shape": list(shape),
                      "wall_s": time.perf_counter() - t0}
        del got, ref, state, grid
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def serial_float32(card, flagship_ms):
    """[32]: compute_dtype="float32" serially (K1's unfused float32 instance,
    the AB2 update outside, K2): one step against "torch", then 8 + 2x32
    steps replayed, per step 1 K1 and 1 K2. Then a float64 state at
    256x128x16 under "auto": one step on the card, which launches no kernel
    (the JAX package's route for a non-float32 state: the plain versions),
    against the same step on the CPU within 1e-10 of each field's largest
    value; "float32" and "bf16s" on that state, one step each against their
    "torch" step, with exactly one K1 launch."""
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab
    from gb25_tpu_torch.utils.cuda_build import launch_counts

    t0 = time.perf_counter()
    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    moved = loop(cfg, grid, state, DT, WARMUP)
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    row = choice_row("float32", cfg, grid, moved, kernels, {"K1": 1, "K2": 1}, CHOICE_STEPS)
    print(f"  float32 on {card}: {row['ms_step']:.3f} ms/step against the fused flagship's "
          f"{flagship_ms:.3f} ([5])")
    del grid, state, moved
    gc.collect()
    torch.cuda.empty_cache()

    shape = (256, 128, 16)
    cfg64, grid_cpu, state_cpu = baroclinic_instability_model(*shape, device="cpu",
                                                              dtype=torch.float64)
    _, grid64, _ = baroclinic_instability_model(*shape, device=DEVICE, dtype=torch.float64)
    before = launch_counts()
    got = time_step(cfg64, grid64, cast_state(state_cpu, DEVICE), DT)
    torch.cuda.synchronize()
    made = {k.source: c - before.get(k, 0) for k, c in launch_counts().items()
            if c != before.get(k, 0)}
    if made:
        raise AssertionError(f"a float64 state under 'auto' launched kernels: {made}")
    want = time_step(cfg64, grid_cpu, state_cpu, DT)
    errs = {}
    for name, (x, y) in {"u": (got.u, want.u), "v": (got.v, want.v), "eta": (got.eta, want.eta),
                         **{k: (got.tracers[k], want.tracers[k]) for k in got.tracers},
                         "Gu": (got.Gu, want.Gu), "Gv": (got.Gv, want.Gv)}.items():
        y = y.to(DEVICE)
        errs[name] = compare(f"f64 {name}", x, y, 0.0, 1e-10 * float(y.abs().max()))
    print(f"  float64 state {'x'.join(map(str, shape))} under 'auto' on the card: no kernel "
          "launched, one step within 1e-10 of each field's largest value of the CPU step")
    # "float32" and "bf16s" hand K1 float32 copies of a float64 state's fields
    # and grid: one launch of its unfused instance, K2's plain version; after
    # WARMUP steps, as from rest Gu is too small for [5]'s atol
    state64 = loop(cfg64, grid64, cast_state(state_cpu, DEVICE), DT, WARMUP)
    modes = {}
    for mode in ("float32", "bf16s"):
        cfg_m = dataclasses.replace(cfg64, compute_dtype=mode)
        before = launch_counts()
        phase_step_compare(lambda st: time_step(cfg_m, grid64, st, DT),
                           lambda st: time_step(dataclasses.replace(cfg_m, kernels="torch"),
                                                grid64, st, DT), state64)
        torch.cuda.synchronize()
        modes[mode] = {k.source: c - before.get(k, 0) for k, c in launch_counts().items()
                       if c != before.get(k, 0)}
        if modes[mode] != {pallas_zslab.KERNEL.source: 1}:
            raise AssertionError(f"{mode} on a float64 state launched {modes[mode]}, expected "
                                 "one K1")
        print(f"  {mode} on the float64 state: one K1 launch (unfused, on float32 copies), "
              "no other kernel, one step against its 'torch' step at [5]'s tolerances")
    row.update(wall_s=time.perf_counter() - t0, float64_state={
        "shape": list(shape), "launches": made, "max_abs_err": errs, "operand_modes": modes})
    return row


# --------------------------------------------------------------------------
# the JAX package's other schemes, the linear equation of state and the b
# tracer: K1's and K6's general instances, [34]-[36]
# --------------------------------------------------------------------------

# (momentum_advection, ke_scheme, tracer_advection): the 20 combinations
# the config accepts, the flagship's first (it runs the compiled instances)
SCHEME_COMBOS = [(mom, ke, tr) for mom, ke in (("weno_vector_invariant", "hollingsworth"),
                                               ("weno_vector_invariant", "standard"),
                                               ("vector_invariant", "hollingsworth"),
                                               ("vector_invariant", "standard"),
                                               ("none", "hollingsworth"))
                 for tr in ("weno5", "centered2", "upwind1", "none")]
ORACLE_SCHEMES = ("vector_invariant", "standard", "centered2")
SCHEME_STEPS, SCHEME_K6_STEPS = 32, 32  # [36]'s timed loops: rows (a), (b); row (c)


def combo_name(combo):
    return "-".join(combo)


def with_schemes(cfg, combo, **kw):
    mom, ke, tr = combo
    return dataclasses.replace(cfg, momentum_advection=mom, ke_scheme=ke, tracer_advection=tr,
                               **kw)


def ptxas_report(kernel):
    """Each entry function of ``kernel``'s build log: (mangled name,
    registers, spill stores, spill loads) from ``nvcc -Xptxas -v``."""
    import re

    out, name, spills = [], None, (0, 0)
    for line in kernel.build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def spills_of(kernel, key):
    """(spill stores, spill loads) of the instance whose mangled name holds
    ``key``, or None where the build log does not show it (a cached
    build)."""
    for name, _, stores, loads in ptxas_report(kernel):
        if key in name:
            return [stores, loads]
    return None


def k1_key(ntr, immersed, metric2d, fused=True, bf16=False, general=True):
    return (f"zslab_tendencies_kernelILi{ntr}ELb{int(immersed)}ELb{int(metric2d)}ELb{int(fused)}"
            f"E{'13__nv_bfloat16' if bf16 else 'f'}Lb{int(general)}EE")


def k6_key(ntr, mode, metric2d, general=True, bf16=False, dtype=None):
    """A K6 instance's mangled name; ``dtype``: its storage type's mangling
    ("f", "13__nv_bfloat16", "d"), else by ``bf16``."""
    dtype = dtype or ("13__nv_bfloat16" if bf16 else "f")
    return (f"tendency_stage_kernelILi{ntr}ELi{mode}ELb{int(metric2d)}ELb{int(general)}"
            f"E{dtype}EE")


def k1_general_case(label, cfg, grid, ue, ve, tr_e, be, b_total, prev, fused=True):
    """One general K1 instance against its plain version at K1's
    tolerances (fused: ``check_k1``; unfused: the tendencies and the wall
    row), the kernel alone and the plain version timed, its launch shape,
    spills and bound."""
    from gb25_tpu_torch.grids.immersed import face_bottom_planes
    from gb25_tpu_torch.ops import pallas_zslab as z

    ntr = len(tr_e)
    fb = face_bottom_planes(grid) if grid.immersed and fused else None
    ab = (float(torch.tensor(DT * 1.6, dtype=torch.float32)),
          float(torch.tensor(DT * -0.6, dtype=torch.float32)))
    before = z.KERNEL.launches
    if fused:
        got = z.zslab_tendencies(cfg, grid, ue, ve, tr_e, prev, ab, buoyancy=(be, b_total),
                                 face_bottoms=fb)
        want = z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb)
        torch.cuda.synchronize()
        errs = check_k1(got, want, ab, grid, tuple(tr_e), prev)

        def run():
            return z.zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab, fb)

        def run_plain():
            return z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, prev, ab, be, fb)
    else:
        got = z.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=(be, b_total))
        want = z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be)
        torch.cuda.synchronize()
        errs = [compare("Gu", got[0], want[0], 2e-4, 1e-9),
                compare("Gv", got[1], want[1], 2e-4, 1e-9)]
        errs += [compare("G" + k, got[2][k], want[2][k], 2e-4, 1e-7) for k in tr_e]
        if float(got[1][:, 0, :].abs().max()) != 0.0:
            raise AssertionError(f"K1 {label} left Gv nonzero on the south wall row")

        def run():
            return z.zslab_kernel_unfused(cfg, grid, ue, ve, tr_e, be, b_total)

        def run_plain():
            return z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be)
    if z.KERNEL.launches != before + 1:
        raise AssertionError(f"K1 {label}: {z.KERNEL.launches - before} launches, expected 1")
    if cfg.tracer_advection == "none" and any(got[2][k].any() for k in tr_e):
        raise AssertionError(f"K1 {label}: a tracer tendency is not 0 under 'none'")
    del got, want
    ms = cuda_time_ms(run, reps=10)
    plain_ms = cuda_time_ms(run_plain, reps=2)
    info = z.kernel_info(ntr, fb is not None, grid.north_fold, "fused" if fused else "unfused",
                         general=True)
    b = k1_bound(cfg, grid, ntr, fb is not None, fused)
    spills = spills_of(z.KERNEL, k1_key(ntr, fb is not None, grid.north_fold, fused))
    print(f"  K1 general {label}: alone {ms:.3f} ms; plain {plain_ms:.3f} ms; spills (stores, "
          f"loads) {spills}; " + launch_line(info, b))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "launch": info, "spills": spills}


def linear_b(tr_e):
    """The b tracer's operands: b, the linear buoyancy of T and S."""
    from gb25_tpu_torch.ops.eos import LinearEquationOfState

    return {"b": LinearEquationOfState().buoyancy(tr_e["T"], tr_e["S"], None).contiguous()}


def k1_general_instances():
    """[34]: K1's general instances against their plain versions at
    1536x768x64: the 19 combinations other than the flagship's on the
    flat two-tracer fused instance (the flagship's is [3]'s compiled
    instance), on the flagship's fields after 8 steps; the one-tracer b
    instance fused and unfused float32; one general instance on the
    islands (3 tracers, immersed), tripolar (3, 2-D metrics) and k-epsilon
    (4) operands with the oracle's schemes."""
    from gb25_tpu_torch import baroclinic_instability_model, data_free_ocean_climate_model, loop
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops import pallas_zslab as z
    from gb25_tpu_torch.ops.halos import extend_field

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    state = loop(cfg, grid, state, DT, WARMUP)
    gen = torch.Generator(device=DEVICE).manual_seed(2468)

    def noise(shape_grid):
        return 1e-7 * torch.randn(shape_grid.shape, generator=gen, device=DEVICE)

    def prev_of(g, names):
        Gv_p = noise(g)
        Gv_p[:, 0, :] = 0.0
        return (noise(g), Gv_p, {k: noise(g) for k in names})

    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    be, b_total = z.column_buoyancy(cfg, grid, tr_e)
    prev = prev_of(grid, tr_e)
    combos = {}
    for combo in SCHEME_COMBOS[1:]:
        combos[combo_name(combo)] = k1_general_case(
            combo_name(combo), with_schemes(cfg, combo), grid, ue, ve, tr_e, be, b_total, prev)
    out = {"schemes": combos}
    cfg_b = dataclasses.replace(cfg, tracers=("b",))
    tr_b = linear_b(tr_e)
    be_b, bt_b = z.column_buoyancy(cfg_b, grid, tr_b)
    if be_b is not tr_b["b"]:
        raise AssertionError("the b tracer's buoyancy is not the tracer itself")
    prev_b = prev_of(grid, tr_b)
    out["b_tracer"] = k1_general_case("b tracer (one tracer, fused)", cfg_b, grid, ue, ve, tr_b,
                                      be_b, bt_b, prev_b)
    out["b_tracer_unfused"] = k1_general_case("b tracer (one tracer, unfused float32)", cfg_b,
                                              grid, ue, ve, tr_b, be_b, bt_b, None, fused=False)
    del ue, ve, tr_e, be, b_total, prev, tr_b, be_b, bt_b, prev_b, state, grid
    torch.cuda.empty_cache()
    geometries = {}
    for grid_type in ("gaussian_islands", "gaussian_islands_tripolar"):
        ccfg, grid, _, state = data_free_ocean_climate_model(resolution=RESOLUTION, Nz=NZ,
                                                             device=DEVICE, grid_type=grid_type)
        ue, ve, tr_e, be, b_total, prev = climate_operands(
            ccfg.ocean, grid, state, torch.Generator(device=DEVICE).manual_seed(1357))
        label = "tripolar" if grid.north_fold else "islands"
        geometries[label] = k1_general_case(f"{label} ({combo_name(ORACLE_SCHEMES)})",
                                            with_schemes(ccfg.ocean, ORACLE_SCHEMES), grid, ue,
                                            ve, tr_e, be, b_total, prev)
        del ccfg, grid, state, ue, ve, tr_e, be, b_total, prev
        torch.cuda.empty_cache()
    kcfg, grid, state = baroclinic_instability_model(
        NX, NY, NZ, device=DEVICE, closure=TKEDissipationVerticalDiffusivity())
    ue, ve, tr_e = keps_operands(grid, state, torch.Generator(device=DEVICE).manual_seed(97531))
    be, b_total = z.column_buoyancy(kcfg, grid, tr_e)
    geometries["four_tracers"] = k1_general_case(
        f"k-epsilon four tracers ({combo_name(ORACLE_SCHEMES)})",
        with_schemes(kcfg, ORACLE_SCHEMES), grid, ue, ve, tr_e, be, b_total,
        prev_of(grid, tr_e))
    out["geometries"] = geometries
    return out


def k6_general_case(label, cfg, grid, ue, ve, tr_e, split=False):
    """One general K6 instance (with ``split`` its momentum and tracer
    launches) bit for bit with the plain version, the kernel alone and the
    plain version timed, its launch shape, spills and bound."""
    from gb25_tpu_torch.ops import pallas_tendency as k6
    from gb25_tpu_torch.ops.operators import coriolis_ff

    f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
    pallas = dataclasses.replace(cfg, kernels="pallas")
    args = (pallas, grid, f_ff, ue, ve, tr_e)
    before = k6.KERNEL.launches
    got = k6.pallas_tendencies(*args, split=split)
    want = k6.pallas_tendencies_plain(*args)
    torch.cuda.synchronize()
    if k6.KERNEL.launches != before + 1 + int(split):
        raise AssertionError(f"K6 {label}: {k6.KERNEL.launches - before} launches")
    pairs = [("Gu", got[0], want[0]), ("Gv", got[1], want[1])]
    pairs += [("G" + k, got[2][k], want[2][k]) for k in tr_e]
    errs = [compare(n, g, w, 0.0, 0.0) for n, g, w in pairs]
    del got, want

    def run():
        if split:
            return k6.tendency_kernel(*args, "momentum"), k6.tendency_kernel(*args, "tracers")
        return k6.tendency_kernel(*args)

    ms = cuda_time_ms(run, reps=10)
    plain_ms = cuda_time_ms(lambda: k6.pallas_tendencies_plain(*args), reps=2)
    ntr = len(tr_e)
    info = k6.kernel_info(ntr, "all", grid.north_fold, general=True)
    b = k6_bound(cfg, grid, ntr)
    spills = spills_of(k6.KERNEL, k6_key(ntr, 0, grid.north_fold))
    launch = info
    if split:
        nb = 1 if "b" in tr_e else 2
        launch = {"momentum": k6.kernel_info(nb, "momentum", grid.north_fold, general=True),
                  "tracers": k6.kernel_info(ntr, "tracers", grid.north_fold, general=True)}
        spills = [spills_of(k6.KERNEL, k6_key(nb, 1, grid.north_fold)),
                  spills_of(k6.KERNEL, k6_key(ntr, 2, grid.north_fold))]
    print(f"  K6 general {label}{' (split pair)' if split else ''}: bit for bit; alone "
          f"{ms:.3f} ms; plain {plain_ms:.3f} ms; spills (stores, loads) {spills}; "
          + launch_line(launch["momentum"] if split else launch, b))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "bitwise": True, "launch": launch, "spills": spills}


def k6_general_instances():
    """[35]: K6's general instances bit for bit with the plain version at
    1536x768x64 on the flagship's fields after 8 steps: the 19 combinations
    other than the flagship's under TEOS-10 (the flagship's is [22]'s
    compiled instance), the linear equation of state with the oracle's
    schemes, and the b tracer, in one launch and as the split pair (whose
    momentum launch stages b alone)."""
    from gb25_tpu_torch import baroclinic_instability_model, loop
    from gb25_tpu_torch.ops.eos import LinearEquationOfState
    from gb25_tpu_torch.ops.halos import extend_field

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    state = loop(cfg, grid, state, DT, WARMUP)
    ue = extend_field(grid, state.u, "u")
    ve = extend_field(grid, state.v, "v")
    tr_e = {k: extend_field(grid, c, "c") for k, c in state.tracers.items()}
    out = {"schemes": {combo_name(c): k6_general_case(combo_name(c), with_schemes(cfg, c), grid,
                                                      ue, ve, tr_e)
                       for c in SCHEME_COMBOS[1:]}}
    out["linear"] = k6_general_case(f"linear EOS ({combo_name(ORACLE_SCHEMES)})",
                                    with_schemes(cfg, ORACLE_SCHEMES,
                                                 eos=LinearEquationOfState()),
                                    grid, ue, ve, tr_e)
    cfg_b = dataclasses.replace(cfg, tracers=("b",))
    tr_b = linear_b(tr_e)
    out["b_tracer"] = k6_general_case("b tracer", cfg_b, grid, ue, ve, tr_b)
    out["b_tracer_split"] = k6_general_case("b tracer", cfg_b, grid, ue, ve, tr_b, split=True)
    return out


@contextlib.contextmanager
def plain_versions():
    """Every wrapper takes its plain version, on the card too: a step run
    inside is its route's plain path (on the K6 route K6's and K5's plain
    versions, where kernels="torch" would take the K1 route)."""
    from gb25_tpu_torch.ops import (
        pallas_barotropic,
        pallas_catke,
        pallas_tendency,
        pallas_tridiag,
        pallas_zslab,
    )

    mods = (pallas_barotropic, pallas_catke, pallas_tendency, pallas_tridiag, pallas_zslab)
    saved = [m.uses_kernel for m in mods]
    for m in mods:
        m.uses_kernel = lambda *args: False
    try:
        yield
    finally:
        for m, f in zip(mods, saved):
            m.uses_kernel = f


def k6_route_witness(cfg, grid, state):
    """[36] (c)'s K6 route against the "torch" route (K1's plain version,
    K2). In float32 the two part in u, v and eta by rounding that the
    barotropic forcing amplifies (``route_step_compare``); under (c)'s
    schemes by more than [23]'s 1e-3 of the largest eta at one element.
    So the routes are held to each other in float64 from ``state``, the
    K6 route through its wrappers' plain versions (``plain_versions``), at
    1e-10 of each field's largest value: the same arithmetic. Printed: each
    float32 route's distance from the float64 "torch" step, and the eta
    element where the float32 routes part most, with its three values."""
    from gb25_tpu_torch import baroclinic_instability_model, time_step

    cfg_torch = dataclasses.replace(cfg, kernels="torch")
    a, b = time_step(cfg, grid, state, DT), time_step(cfg_torch, grid, state, DT)
    grid64 = baroclinic_instability_model(grid.Nx, grid.Ny, grid.Nz, device=DEVICE,
                                          dtype=torch.float64)[1]
    s64 = cast_state(state, torch.float64)
    c = time_step(cfg_torch, grid64, s64, DT)
    with plain_versions():
        d = time_step(cfg, grid64, s64, DT)
    del grid64, s64
    for name in ("u", "v", "eta", "Gu", "Gv"):
        x, y, z = (getattr(a, name).double(), getattr(b, name).double(), getattr(c, name))
        print(f"  {name}: K6 route against 'torch' route {float((x - y).abs().max()):.3e}; "
              f"against the float64 step (max {float(z.abs().max()):.4e}): K6 route "
              f"{float((x - z).abs().max()):.3e}, 'torch' route {float((y - z).abs().max()):.3e}")
    x, y, z = a.eta.double(), b.eta.double(), c.eta
    i = int((x - y).abs().argmax())
    idx = tuple(int(j) for j in torch.unravel_index(torch.tensor(i), x.shape))
    print(f"  eta where the routes part most {idx}: K6 route {float(x.flatten()[i]):.9e}, "
          f"'torch' route {float(y.flatten()[i]):.9e}, float64 {float(z.flatten()[i]):.9e}")
    del a, b, x, y, z
    print("  float64: the K6 route's plain path against the 'torch' step")
    pairs = {n: (getattr(d, n), getattr(c, n)) for n in ("u", "v", "eta", "Gu", "Gv")}
    pairs |= {k: (d.tracers[k], c.tracers[k]) for k in c.tracers}
    pairs |= {"G" + k: (d.Gtracers[k], c.Gtracers[k]) for k in c.Gtracers}
    for name, (x, y) in pairs.items():
        compare("f64 " + name, x, y, 0.0, 1e-10 * float(y.abs().max()))
    del c, d, pairs
    torch.cuda.empty_cache()


def scheme_row(card, label, cfg, grid, state, kernels, per_step, steps):
    """One of [36]'s rows: 8 float32 steps, one step against its route's
    plain path at [5]'s tolerances (the K1 route's is kernels="torch"; the
    K6 route's its wrappers' plain versions, ``plain_versions``, and
    ``k6_route_witness``), the main
    path (``run_main_path``: 8 warm-up steps and two ``steps``-step loops
    replayed), the fields finite, the device loop against the host loop
    bit for bit over 16 steps, and the replayed loop's device busy and idle
    share over 32 steps under the profiler."""
    from gb25_tpu_torch import loop, time_step
    from gb25_tpu_torch.utils.profiling import replayed_line

    t0 = time.perf_counter()
    moved = loop(cfg, grid, state, DT, WARMUP)
    cfg_plain = dataclasses.replace(cfg, kernels="torch")
    step = lambda s: time_step(cfg, grid, s, DT)  # noqa: E731

    def plain_step(s):
        if cfg.kernels != "pallas":
            return time_step(cfg_plain, grid, s, DT)
        with plain_versions():
            return time_step(cfg, grid, s, DT)

    phase_step_compare(step, plain_step, moved)
    if cfg.kernels == "pallas":
        k6_route_witness(cfg, grid, moved)
    step_n = lambda st, n: loop(cfg, grid, st, DT, n)  # noqa: E731
    s, elapsed, launches, peak_gb, rec = run_main_path(step_n, moved, kernels, per_step, steps)
    umax = check_state(s, grid.shape)
    ms_step = 1e3 * elapsed / steps
    host_ms = loop_vs_host(label, step_n, host_steps(
        lambda st: time_step(cfg, grid, st, DT, premasked=True), grid), s, ms_step)
    wall, busy, _, _, s = replayed_line(step_n, s, 2 * 16)
    idle = 1.0 - busy / wall
    rate = grid.Nx * grid.Ny * grid.Nz * steps / elapsed
    print(f"  {label} {grid.Nx}x{grid.Ny}x{grid.Nz} f32 on {card}: {ms_step:.3f} ms/step "
          f"({rate:.4e} cell-steps/s, timed second {steps}-step loop, replayed); launched from "
          f"the host {host_ms:.3f} ms/step; replayed under the profiler: wall {wall:.3f}, device "
          f"busy {busy:.3f} ms/step, idle {100 * idle:.1f}%; max|u| {umax:.4f} m/s; peak "
          f"device memory {peak_gb:.2f} GB, graph pool {rec['pool_gb']:.2f} GB; "
          f"{time.perf_counter() - t0:.1f} s")
    return {"ms_step": ms_step, "rate": rate, "host_ms_step": host_ms, "steps": steps,
            "launches": launches, "loop": rec, "peak_gb": peak_gb, "busy_ms": busy,
            "profiled_wall_ms": wall, "idle": idle}


def scheme_rows(card):
    """[36]: (a) the oracle's schemes (centred vector-invariant momentum,
    standard kinetic energy, centred tracers) with the linear equation of
    state on the flagship under the split-explicit free surface: K1's
    general fused instance and K2; (b) the b-tracer flagship, b the linear
    buoyancy of its analytic T and S, the WENO schemes: K1's one-tracer
    instance and K2; (c) row (a) on the K6 route: K6's general instance
    with the linear equation of state, K5 at W = 4."""
    from gb25_tpu_torch import baroclinic_instability_model
    from gb25_tpu_torch.models import buoyancy_tracer_state
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_zslab
    from gb25_tpu_torch.ops.eos import LinearEquationOfState

    k1_kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    rows = {}
    for name, kernels in (("oracle_schemes", "auto"), ("oracle_schemes_k6", "pallas")):
        mom, ke, tr = ORACLE_SCHEMES
        cfg, grid, state = baroclinic_instability_model(
            NX, NY, NZ, device=DEVICE, kernels=kernels, momentum_advection=mom,
            tracer_advection=tr, eos=LinearEquationOfState())
        cfg = dataclasses.replace(cfg, ke_scheme=ke)
        if kernels == "auto":
            print(f"  (a) the oracle's schemes with the linear EOS: {WARMUP} steps, one against "
                  f"'torch', {WARMUP} + 2x{SCHEME_STEPS} steps replayed")
            rows[name] = scheme_row(card, "oracle schemes", cfg, grid, state, k1_kernels,
                                    {"K1": 1, "K2": 1}, SCHEME_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
            cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
            cfg = dataclasses.replace(cfg, tracers=("b",))
            print(f"  (b) the b-tracer flagship: {WARMUP} steps, one against 'torch', "
                  f"{WARMUP} + 2x{SCHEME_STEPS} steps replayed")
            rows["b_tracer"] = scheme_row(card, "b tracer", cfg, grid,
                                          buoyancy_tracer_state(state, grid), k1_kernels,
                                          {"K1": 1, "K2": 1}, SCHEME_STEPS)
        else:
            print(f"  (c) row (a) on the K6 route: {WARMUP} steps, one against its plain path, "
                  f"{WARMUP} + 2x{SCHEME_K6_STEPS} steps replayed")
            per_step = {"K6": 1, "K5": k5_per_step(cfg, grid), "K1": 0, "K2": 0}
            rows[name] = scheme_row(card, "oracle schemes, K6 route", cfg, grid, state,
                                    k6_kernels(), per_step, SCHEME_K6_STEPS)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def scheme_phases(card, flagship_ms):
    """[34]-[36]; returns the new kernel entries and [36]'s rows."""
    t0 = time.perf_counter()
    print(f"[34] K1's general instances vs plain at {NX}x{NY}x{NZ}")
    k1g = k1_general_instances()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [34] {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"[35] K6's general instances vs plain at {NX}x{NY}x{NZ}, bit for bit")
    k6g = k6_general_instances()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [35] {time.perf_counter() - t0:.1f} s")
    print("[36] the schemes' main paths")
    rows = scheme_rows(card)
    print("  ms/step beside the flagship's " + f"{flagship_ms:.3f} ([5]): " + "; ".join(
        f"{name} {r['ms_step']:.3f} (idle {100 * r['idle']:.1f}%)" for name, r in rows.items()))

    def scheme_entry(name, source, replaces, path, kernel, res, subs):
        row = rows[path]
        e = entry(name, source, replaces, path, row["launches"][kernel], res,
                  (res["bound_ms"], res["bound_by"]))
        return e | {"spills": res["spills"]} | on_device(row["loop"], kernel) | subs

    k1_src, k1_tpu = "zslab_tendencies.cu", "gb25_tpu/ops/pallas_zslab.py:275"
    oracle = k1g["schemes"][combo_name(ORACLE_SCHEMES)]
    entries = [
        scheme_entry("zslab_tendencies_general", k1_src, k1_tpu, "oracle_schemes", "K1", oracle,
                     {"schemes": k1g["schemes"], "geometries": k1g["geometries"]}),
        scheme_entry("zslab_tendencies_one_tracer", k1_src, k1_tpu, "b_tracer", "K1",
                     k1g["b_tracer"], {"unfused": k1g["b_tracer_unfused"]}),
        scheme_entry("pallas_tendencies_general", "tendencies.cu",
                     "gb25_tpu/ops/pallas_tendency.py:115", "oracle_schemes_k6", "K6",
                     k6g["linear"], {"schemes": k6g["schemes"], "b_tracer": k6g["b_tracer"],
                                     "b_tracer_split": k6g["b_tracer_split"],
                                     "bitwise": True}),
    ]
    return entries, rows


# --------------------------------------------------------------------------
# every compute_dtype on every route and closure: [37]-[39]
# --------------------------------------------------------------------------

PRECISION_ROW_STEPS = 32  # [39]'s timed loops: 8 + 32 + 32 steps, as [36] (c)


def precision_fields(geometry):
    """[37]/[38]'s operands at 1536x768x64: (config, grid, extended u, v
    and T, S, e, eps) of the k-epsilon flagship's lat-lon grid (``flat``)
    or the tripolar climate's (eps added)."""
    from gb25_tpu_torch import baroclinic_instability_model, data_free_ocean_climate_model
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops.halos import extend_field

    gen = torch.Generator(device=DEVICE).manual_seed(8080)
    if geometry == "flat":
        cfg, grid, state = baroclinic_instability_model(
            NX, NY, NZ, device=DEVICE, closure=TKEDissipationVerticalDiffusivity())
        ue, ve, tr_all = keps_operands(grid, state, gen)
    else:
        ccfg, grid, _, state = data_free_ocean_climate_model(
            resolution=RESOLUTION, Nz=NZ, device=DEVICE, grid_type="gaussian_islands_tripolar")
        cfg = ccfg.ocean
        ue, ve, tr_all, _, _, _ = climate_operands(cfg, grid, state, gen)
        eps = 1e-8 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE))
        tr_all["eps"] = extend_field(grid, eps, "c")
    return cfg, grid, ue, ve, tr_all


def with_tracers(cfg, tr_all, ntr):
    """``ntr`` of ``precision_fields``' tracers, b alone (1, the linear
    buoyancy of T and S), T and S (2), T, S, e (3), T, S, e, eps (4), with
    the config that advects them."""
    from gb25_tpu_torch.models.catke import CATKEVerticalDiffusivity
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity

    if ntr == 1:
        return dataclasses.replace(cfg, tracers=("b",), closure=None), linear_b(tr_all)
    names = ("T", "S", "e", "eps")[:ntr]
    closure = {2: None, 3: CATKEVerticalDiffusivity(),
               4: TKEDissipationVerticalDiffusivity()}[ntr]
    return (dataclasses.replace(cfg, tracers=names, closure=closure),
            {k: tr_all[k] for k in names})


def k1_unfused_case(label, cfg, grid, ue, ve, tr_e, storage, general):
    """One unfused K1 instance against its plain version at K1's
    tolerances (one launch, the wall row 0), the kernel alone timed (10
    launches) and its plain version (one call), its launch shape, spills
    and bound."""
    from gb25_tpu_torch.ops import pallas_zslab as z

    be, b_total = z.column_buoyancy(cfg, grid, tr_e)
    before = z.KERNEL.launches
    got = z.zslab_tendencies(cfg, grid, ue, ve, tr_e, buoyancy=(be, b_total), storage=storage)
    want = z.zslab_tendencies_plain(cfg, grid, ue, ve, tr_e, be=be, storage=storage)
    torch.cuda.synchronize()
    if z.KERNEL.launches != before + 1:
        raise AssertionError(f"K1 {label}: {z.KERNEL.launches - before} launches, expected 1")
    errs = [compare("Gu", got[0], want[0], 2e-4, 1e-9), compare("Gv", got[1], want[1], 2e-4, 1e-9)]
    errs += [compare("G" + k, got[2][k], want[2][k], 2e-4, 1e-7) for k in tr_e]
    if float(got[1][:, 0, :].abs().max()) != 0.0:
        raise AssertionError(f"K1 {label} left Gv nonzero on the south wall row")
    del got, want
    ops = ((ue, ve, tr_e, be, b_total) if storage is None
           else z.bf16_operands(cfg, grid, ue, ve, tr_e))
    ms = cuda_time_ms(lambda: z.zslab_kernel_unfused(cfg, grid, *ops), reps=10)
    plain_ms = cuda_time_ms(lambda: z.zslab_tendencies_plain(
        cfg, grid, ue, ve, tr_e, be=be, storage=storage), reps=1, warmup=0)
    del ops
    ntr, bf16 = len(tr_e), storage is not None
    form = "unfused_bf16" if bf16 else "unfused"
    info = z.kernel_info(ntr, False, grid.north_fold, form, general=general)
    b = k1_bound(cfg, grid, ntr, False, False, 2 if bf16 else 4)
    spills = spills_of(z.KERNEL, k1_key(ntr, False, grid.north_fold, False, bf16, general))
    print(f"  K1 {label}: alone {ms:.3f} ms; plain {plain_ms:.3f} ms; spills (stores, loads) "
          f"{spills}; " + launch_line(info, b))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "launch": info, "spills": spills}


def k6_bf16_case(label, cfg, grid, ue, ve, tr_e):
    """One K6 bfloat16 instance on ``ue``, ``ve``, ``tr_e``, f and the grid
    cast to bfloat16: one launch, bfloat16 outputs bit for bit with the
    plain twin (float32 on the widened operands, rounded once); the kernel
    alone and the twin timed, launch shape, spills and bound (2-byte
    values)."""
    from gb25_tpu_torch.ops import pallas_tendency as k6
    from gb25_tpu_torch.ops.operators import coriolis_ff

    bf = torch.bfloat16
    args = (dataclasses.replace(cfg, kernels="pallas"), grid.cast(bf),
            coriolis_ff(grid, cfg.coriolis).to(bf), ue.to(bf), ve.to(bf),
            {k: c.to(bf) for k, c in tr_e.items()})
    before = k6.KERNEL.launches
    got = k6.pallas_tendencies(*args)
    want = k6.pallas_tendencies_plain(*args)
    torch.cuda.synchronize()
    if k6.KERNEL.launches != before + 1:
        raise AssertionError(f"K6 {label}: {k6.KERNEL.launches - before} launches")
    pairs = [("Gu", got[0], want[0]), ("Gv", got[1], want[1])]
    pairs += [("G" + k, got[2][k], want[2][k]) for k in tr_e]
    if any(g.dtype != bf for _, g, _ in pairs):
        raise AssertionError(f"K6 {label}: outputs not bfloat16")
    errs = [compare(n, g, w, 0.0, 0.0) for n, g, w in pairs]
    del got, want, pairs
    ms = cuda_time_ms(lambda: k6.tendency_kernel(*args), reps=10)
    plain_ms = cuda_time_ms(lambda: k6.pallas_tendencies_plain(*args), reps=1, warmup=0)
    ntr = len(tr_e)
    info = k6.kernel_info(ntr, "all", grid.north_fold, general=True, dtype=bf)
    b = k6_bound(cfg, grid, ntr, value_bytes=2)
    spills = spills_of(k6.KERNEL, k6_key(ntr, 0, grid.north_fold, bf16=True))
    print(f"  K6 {label}: bit for bit; alone {ms:.3f} ms; plain {plain_ms:.3f} ms; spills "
          f"(stores, loads) {spills}; " + launch_line(info, b))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "bitwise": True, "launch": info, "spills": spills}


def precision_instances():
    """[37] and [38] at 1536x768x64, on each geometry's operands (built
    once; ``precision_fields``), for one to four tracers
    (``with_tracers``): [37] every unfused K1 instance, float32 and bf16
    storage, the flagship's schemes compiled in (two tracers or more) and
    the general instance (the oracle's schemes); [38] K6's bfloat16
    instance."""
    k1u, k6b = {}, {}
    for geometry in ("flat", "tripolar"):
        cfg_all, grid, ue, ve, tr_all = precision_fields(geometry)
        for ntr in (1, 2, 3, 4):
            cfg, tr_e = with_tracers(cfg_all, tr_all, ntr)
            s = "s" if ntr > 1 else ""
            for general in (False, True) if ntr > 1 else (True,):
                c = with_schemes(cfg, ORACLE_SCHEMES) if general else cfg
                for storage in (None, torch.bfloat16):
                    label = (f"unfused {'bf16' if storage is not None else 'f32'} {geometry} "
                             f"{ntr} tracer{s} {'general' if general else 'flagship'}")
                    k1u[label] = k1_unfused_case(label, c, grid, ue, ve, tr_e, storage, general)
            label = f"bf16 {geometry} {ntr} tracer{s}"
            k6b[label] = k6_bf16_case(label, cfg, grid, ue, ve, tr_e)
            gc.collect()
            torch.cuda.empty_cache()
        del cfg_all, grid, ue, ve, tr_all
        gc.collect()
        torch.cuda.empty_cache()
    return k1u, k6b


def precision_model(row, tripolar):
    """A [39] row's step functions at 1536x768x64: (grid, state,
    step(s), step_n(s, n), host_n(s, n), the float32 step or None, the
    ocean's config, the per-step launches, the kernels to count, dt).
    ``tripolar``: the tripolar climate's (config, grid, atmosphere, state),
    built once for its rows (the grid keeps one captured graph: a row with
    another step frees the last row's)."""
    from gb25_tpu_torch import (
        baroclinic_instability_model,
        coupled_loop,
        coupled_time_step,
        loop,
        time_step,
    )
    from gb25_tpu_torch.models import ExplicitFreeSurface
    from gb25_tpu_torch.models.config import SplitExplicitFreeSurface
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops import pallas_catke, pallas_tridiag
    from gb25_tpu_torch.parallel import make_mesh, sharded_coupled_step_fn

    model, mode, kernels_mode = {
        "d": ("tripolar", "bf16s", "auto"), "e": ("tripolar", "float32", "auto"),
        "f": ("keps", "float32", "auto"), "g": ("flagship", "bfloat16", "pallas"),
        "h": ("tripolar", "bfloat16", "pallas"), "i": ("tripolar", None, "auto"),
        "j": ("tripolar", "bf16s", "auto")}[row]
    dt = EXPLICIT_DT if row == "i" else DT
    kernels = {**k6_kernels(), "K3": pallas_tridiag.KERNEL}
    if model == "tripolar":
        ccfg, grid, atmos, state = tripolar
        ocean = dataclasses.replace(ccfg.ocean, compute_dtype=mode, kernels=kernels_mode)
        if row == "i":
            ocean = dataclasses.replace(ocean, free_surface=ExplicitFreeSurface())
        if row == "j":
            ocean = dataclasses.replace(
                ocean, free_surface=SplitExplicitFreeSurface(exchange_width=DECOMPOSED_W))
        ccfg = dataclasses.replace(ccfg, ocean=ocean)
        f32 = dataclasses.replace(ccfg, ocean=dataclasses.replace(ocean, compute_dtype=None))
        kernels["K4"] = pallas_catke.KERNEL
        n3 = 3
        if row == "j":
            fn = sharded_coupled_step_fn(ccfg, grid, atmos, make_mesh(), force_comm="local")
            step, step_n = (lambda s: fn(s, dt)), (lambda s, n: fn(s, dt, n))
            host_n = host_steps(functools.partial(fn.step, dt=dt), fn.grid)
            step32 = None
        else:
            step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=dt)

            def step_n(s, n):
                return coupled_loop(ccfg, grid, atmos, s, dt, n)

            host_n = host_steps(functools.partial(coupled_time_step, ccfg, grid, atmos, dt=dt,
                                                  premasked=True), grid)
            step32 = functools.partial(coupled_time_step, f32, grid, atmos, dt=dt)
    else:
        closure = TKEDissipationVerticalDiffusivity() if model == "keps" else None
        cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                        kernels=kernels_mode, closure=closure)
        ocean = dataclasses.replace(cfg, compute_dtype=mode)
        step = functools.partial(time_step, ocean, grid, dt=dt)

        def step_n(s, n):
            return loop(ocean, grid, s, dt, n)

        host_n = host_steps(functools.partial(time_step, ocean, grid, dt=dt, premasked=True),
                            grid)
        step32 = functools.partial(time_step, cfg, grid, dt=dt)
        n3 = 4 if closure else 0
        if closure:
            kernels["K4_keps"] = pallas_catke.KEPS_KERNEL
    k6 = kernels_mode == "pallas"
    explicit = row == "i"
    per_step = {"K6": int(k6), "K1": int(not k6), "K2": int(not k6 and not explicit and row != "j"),
                "K5": k5_per_step(ocean, grid) if k6 or row == "j" else 0, "K3": n3}
    per_step |= {name: 1 for name in ("K4", "K4_keps") if name in kernels}
    return grid, state, step, step_n, host_n, step32, ocean, per_step, kernels, dt


def precision_row(card, row, label, tripolar):
    """One of [39]'s rows: 8 steps; one step against its route's plain
    path (every wrapper's plain version, ``plain_versions``) at [5]'s
    tolerances; its distance from the float32 step printed (not bounded,
    as [27]'s); the main path (8 + 32 + 32 steps replayed, the launches per
    step held, the profiler probe); the fields finite (land at rest on the
    climate); the device loop against the host loop over 16 steps."""
    t0 = time.perf_counter()
    grid, state, step, step_n, host_n, step32, ocean, per_step, kernels, dt = precision_model(
        row, tripolar)
    moved = step_n(state, WARMUP)
    print(f"  ({row}) {label}: {WARMUP} steps, one against its plain path, then {WARMUP} + "
          f"2x{PRECISION_ROW_STEPS} steps replayed; per step {per_step}")

    def plain_step(s):
        with plain_versions():
            return step(s)

    phase_step_compare(step, plain_step, moved)
    if step32 is not None and ocean.compute_dtype is not None:
        precision_distance(f"({row}) {ocean.compute_dtype}", step(moved), step32(moved),
                           bounded=False)
    s, elapsed, launches, peak_gb, rec = run_main_path(step_n, moved, kernels, per_step,
                                                       PRECISION_ROW_STEPS)
    umax = check_climate_state(s, grid) if "e" in s.tracers and grid.immersed else check_state(
        s, (NZ, NY, NX))
    ms_step = 1e3 * elapsed / PRECISION_ROW_STEPS
    host_ms = loop_vs_host(f"({row}) {label}", step_n, host_n, s, ms_step)
    rate = NX * NY * NZ * PRECISION_ROW_STEPS / elapsed
    wall_s = time.perf_counter() - t0
    print(f"  ({row}) {label} {NX}x{NY}x{NZ} f32 state on {card}: {ms_step:.3f} ms/step "
          f"({rate:.4e} cell-steps/s, timed second {PRECISION_ROW_STEPS}-step loop, replayed); "
          f"from the host {host_ms:.3f} ms/step; max|u| {umax:.4f} m/s; peak device memory "
          f"{peak_gb:.2f} GB, graph pool {rec['pool_gb']:.2f} GB; {wall_s:.1f} s")
    return {"ms_step": ms_step, "rate": rate, "host_ms_step": host_ms,
            "steps": PRECISION_ROW_STEPS, "launches": launches, "loop": rec, "peak_gb": peak_gb,
            "dt": dt, "wall_s": wall_s}


PRECISION_ROWS = {
    "d": "climate tripolar bf16s", "e": "climate tripolar float32", "f": "k-epsilon float32",
    "g": "flagship K6 route bfloat16", "h": "climate tripolar K6 route bfloat16",
    "i": f"climate tripolar explicit free surface dt {EXPLICIT_DT:g} s",
    "j": "climate tripolar bf16s, decomposed 1x1 local",
}


def precision_phases(card):
    """[37]-[39]; returns the new kernel entries and [39]'s rows."""
    t0 = time.perf_counter()
    print(f"[37], [38] at {NX}x{NY}x{NZ}, one to four tracers, columns and tripolar planes: "
          "K1's unfused instances (float32 and bf16 storage) vs plain; K6's bfloat16 "
          "instances vs plain, bit for bit")
    k1u, k6b = precision_instances()
    print(f"  [37], [38] {time.perf_counter() - t0:.1f} s")
    from gb25_tpu_torch import data_free_ocean_climate_model

    print("[39] every compute_dtype on every route and closure: rows (d)-(j)")
    tripolar = data_free_ocean_climate_model(resolution=RESOLUTION, Nz=NZ, device=DEVICE,
                                             grid_type="gaussian_islands_tripolar")
    rows = {}
    for row, label in PRECISION_ROWS.items():
        rows[row] = precision_row(card, row, label, tripolar)
        gc.collect()
        torch.cuda.empty_cache()
    del tripolar

    def row_entry(name, source, replaces, row, kernel, res, subs):
        r = rows[row]
        e = entry(name, source, replaces, f"precision_{row}", r["launches"][kernel], res,
                  (res["bound_ms"], res["bound_by"]))
        return e | {"spills": res["spills"]} | on_device(r["loop"], kernel) | subs

    k1_src, k1_tpu = "zslab_tendencies.cu", "gb25_tpu/ops/pallas_zslab.py:275"
    f32 = {k: v for k, v in k1u.items() if "f32" in k}
    bf16 = {k: v for k, v in k1u.items() if "bf16" in k}
    other = {f"launches_{r}": rows[r]["launches"]["K1"] for r in ("f", "i")}
    entries = [
        row_entry("zslab_tendencies_unfused_tracers", k1_src, k1_tpu, "e", "K1",
                  f32["unfused f32 tripolar 3 tracers flagship"],
                  {"instances": f32, **other}),
        row_entry("zslab_tendencies_bf16_storage_tracers", k1_src, k1_tpu, "d", "K1",
                  bf16["unfused bf16 tripolar 3 tracers flagship"],
                  {"instances": bf16, "launches_j": rows["j"]["launches"]["K1"]}),
        row_entry("pallas_tendencies_bf16", "tendencies.cu",
                  "gb25_tpu/ops/pallas_tendency.py:115", "h", "K6",
                  k6b["bf16 tripolar 3 tracers"],
                  {"instances": k6b, "launches_g": rows["g"]["launches"]["K6"],
                   "bitwise": True}),
    ]
    return entries, rows


# --------------------------------------------------------------------------
# the production-run path: the run script, the prognostic ice, kill and
# resume
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_OUT = os.path.join(ROOT, "smoke_out")  # git-ignored; emptied after each phase
PRODUCTION_RESOLUTION = 0.25  # [40]: the run script's 1440 x 680 tripolar grid
PRODUCTION_STEPS = 70   # [40]: 7 chunks of 10 at dt = 60 s
ICE_STEPS = 32          # [41]: the timed loop
RUN10_DAYS = 0.1        # [42]: 144 steps at dt = 60 s, the checkpoint at step 72
CLIMATE_PER_STEP = {"K1": 1, "K2": 1, "K3": 3, "K4": 1}


def climate_kernels():
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_catke, pallas_tridiag, pallas_zslab

    return {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
            "K3": pallas_tridiag.KERNEL, "K4": pallas_catke.KERNEL}


def probe_chunk(run, per_step, steps, replayed):
    """The profiler's count of each kernel over ``run()`` (``steps`` steps,
    ``replayed`` of them from a graph): all of them, or (a profiler blind
    inside graphs) the host steps' alone; fewer (lost records) repeats, up
    to PROBE_ATTEMPTS; more fails. Returns (seen, method)."""
    want = {k: n * steps for k, n in per_step.items()}
    host = {k: n * (steps - replayed) for k, n in per_step.items()}
    tries = []
    for _ in range(PROBE_ATTEMPTS):
        seen, _ = device_launches(run, per_step)
        tries.append(seen)
        if any(seen[k] > want[k] for k in per_step):
            raise AssertionError(f"the profiler saw {seen} launches over {steps} steps, more "
                                 f"than {want}")
        if seen == want:
            return seen, f"the profiler saw all {steps} probe steps' launches"
        if seen == host:
            return seen, (f"the profiler saw the probe's {steps - replayed} host step(s) and no "
                          f"kernel of its {replayed} replayed steps")
    raise AssertionError(f"the profiler saw fewer launches than {want} in each of "
                         f"{PROBE_ATTEMPTS} probes: {tries}")


def hold_launches(label, kernels, per_step, steps):
    """Hold each kernel's launches on the device since the counts were set
    to 0 to per_step x ``steps``, and the wrappers' counts to per_step x
    the eager and recorded steps; returns the launches on the device."""
    from gb25_tpu_torch.models import device_loop

    stats = device_loop.STATS
    calls = {k: kern.launches for k, kern in kernels.items()}
    launches = {k: stats.launches(kern) for k, kern in kernels.items()}
    wrapper_steps = stats.eager_steps + stats.captured_steps
    if stats.eager_steps + stats.replayed_steps != steps:
        raise AssertionError(f"{label}: {stats.eager_steps} eager and {stats.replayed_steps} "
                             f"replayed steps do not make up the {steps} steps")
    want = {k: n * steps for k, n in per_step.items()}
    want_calls = {k: n * wrapper_steps for k, n in per_step.items()}
    if launches != want or calls != want_calls:
        raise AssertionError(f"{label}: launches on the device {launches} over {steps} steps, "
                             f"expected {want}; through the wrappers {calls}, expected "
                             f"{want_calls}")
    print(f"  launches on the device over {steps} steps: {launches}; through the wrappers "
          f"{calls} ({stats.eager_steps} eager, {stats.captured_steps} recorded by "
          f"{stats.captures} captures, {stats.replayed_steps} replayed in {stats.replays} "
          f"replays)")
    return launches


def capture_step_operands(run_step):
    """Run ``run_step()`` (one host step) with the step's kernel calls and
    its increments wrapped; return each one's operands: "K1"
    (``zslab_tendencies``: cfg, grid, ue, ve, tr_e, prev, ab and the
    keywords), "K2" (``barotropic_loop``), "K3" (each ``implicit_solve``),
    "K4" (``catke_diffusivities_kernel``) and "increments" (``_increments``,
    its tendencies and fused update cloned before the call, which adds to
    them in place)."""
    from gb25_tpu_torch.models import free_surface, hydrostatic

    seen = {"K3": []}

    def clone(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(clone(v) for v in x)
        return x

    def spy(module, name, key):
        wrapped = getattr(module, name)

        def call(*args, **kw):
            if key == "K3":
                seen["K3"].append((args, kw))
            elif key == "increments":
                seen[key] = (args[:1] + clone(args[1:3]) + args[3:], kw)
            else:
                seen[key] = (args, kw)
            return wrapped(*args, **kw)

        setattr(module, name, call)
        return module, name, wrapped

    spies = [spy(hydrostatic, "zslab_tendencies", "K1"),
             spy(free_surface, "barotropic_loop", "K2"),
             spy(hydrostatic, "implicit_solve", "K3"),
             spy(hydrostatic, "catke_diffusivities_kernel", "K4"),
             spy(hydrostatic, "_increments", "increments")]
    try:
        run_step()
    finally:
        for module, name, wrapped in spies:
            setattr(module, name, wrapped)
    return seen


def production_kernels(ops):
    """K1-K4 against their plain versions (and timed) on the operands one
    host step of the run script's own step gave them at its width
    (``capture_step_operands``): K1's tripolar climate instance, K2's fold
    instance on that grid's tiles, K3's three solves, K4."""
    (cfg, grid, ue, ve, tr_e, prev, ab), kw = ops["K1"]
    be, b_total = kw["buoyancy"]
    print(f"  K1-K4 vs plain on the operands of one host step at {grid.Nx}x{grid.Ny}x{grid.Nz}")
    k1 = phase_k1_instance(cfg, grid, ue, ve, tr_e, be, b_total, prev, "run script", ab)
    (c2, g2, eta0, U0, V0, GU, GV, Hu, Hv, dt), kw2 = ops["K2"]
    if dt != DT:
        raise AssertionError(f"the run's barotropic step is {dt} s, not {DT}")
    k2 = time_k2(c2, g2, eta0, U0, V0, GU, GV, Hu, Hv, kw2["mu"], kw2["mv"])
    names = ("u,v", "T,S", "e")
    if len(ops["K3"]) != 3:
        raise AssertionError(f"{len(ops['K3'])} implicit solves in the step, expected 3")
    solves = {}
    for name, (args, kw3) in zip(names, ops["K3"]):
        # implicit_solve(cfg, fields, kappa, dt, a_lam, a_mu, damping=None)
        solves[name] = (args[1], args[2], kw3.get("damping", args[6] if len(args) > 6 else None))
    k3 = phase_k3(cfg, grid, solves)
    (c4, g4, ue4, ve4, be4, ee4), _ = ops["K4"]
    k4, _ = phase_k4(c4, g4, ue4, ve4, be4, ee4)
    substeps = cfg.free_surface.substeps
    out = {}
    for key, res, b in (("K1", k1, k1_bound(cfg, grid, 3, True)),
                        ("K2", k2, k2_bound(grid, substeps, True)),
                        ("K3", k3, (k3["bound_ms"], "bytes")), ("K4", k4, k4_bound(grid))):
        out[key] = {"max_abs_err": res["max_abs_err"], "ms": res["ms"],
                    "plain_ms": res["plain_ms"], "bound_ms": b[0], "bound_by": b[1],
                    "shape": [grid.Nx, grid.Ny, grid.Nz]}
    out["K2"]["bitwise"] = k2["bitwise"]
    out["K2"]["tiles"] = {k: k2["launch"][k] for k in ("tile", "grid", "instance")}
    return out


def time_production_terms(grid, atmos_pre, atmos_gather, increments, state, ice, ccfg):
    """Device times at the run's width: the atmosphere at a model time in
    the pre-regridded and the gather form; the port's ``_increments`` on
    the operands of one step of the run (``capture_step_operands``) with
    its restoring and without, whose difference is what the restoring
    costs a step (T and S: G += inc and the fused x* += dt c1 inc); the
    ice's thermodynamics and advection."""
    from gb25_tpu_torch.models.hydrostatic import _increments
    from gb25_tpu_torch.models.seaice import seaice_advect, seaice_thermodynamics

    t = state.time + 1234.0
    pre_ms = cuda_time_ms(lambda: atmos_pre.at_time(t), 20)
    gather_ms = cuda_time_ms(lambda: atmos_gather.at_time(t), 20)
    for k in atmos_pre.fields:
        a, b = atmos_pre.at_time(t)[k], atmos_gather.at_time(t)[k]
        err = float((a - b).abs().max())
        if err > 1e-4 * max(float(a.abs().max()), 1e-30):
            raise AssertionError(f"the gather form's {k} is {err} from the pre-regridded form")
    args, kw = increments
    if not args[8]:
        raise AssertionError("the run's step passed no restoring to _increments")
    # the tendencies and the fused update grow at each call (G += inc): the
    # time of the arithmetic, not of its values
    with_ms = cuda_time_ms(lambda: _increments(*args, **kw), 10)
    without_ms = cuda_time_ms(lambda: _increments(*args[:8], None, *args[9:], **kw), 10)
    af = atmos_pre.at_time(t)

    def ice_step():
        th, _ = seaice_thermodynamics(ccfg.sea_ice, grid, af, state, ice, DT)
        seaice_advect(ccfg.sea_ice, grid, state, th, af, DT)

    ice_ms = cuda_time_ms(ice_step, 10)
    out = {"atmosphere_pre_regridded_ms": pre_ms, "atmosphere_gather_ms": gather_ms,
           "increments_with_restoring_ms": with_ms, "increments_without_restoring_ms": without_ms,
           "restoring_ms": with_ms - without_ms, "seaice_ms": ice_ms}
    print("  device times at " + f"{grid.Nx}x{grid.Ny}x{grid.Nz}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in out.items()))
    return out


def production_run(card, trip_ms):
    """[40]: the port's ocean_climate_simulation main in this process at
    1/4 degree on the tripolar grid (1440x680x64) with the slab ice, the
    synthetic restoring and initialization and NetCDF output, over
    ``PRODUCTION_STEPS`` steps: every full chunk of 10 replays from a
    graph (only the Euler step runs eagerly), 1 K1, 1 K2, 3 K3 and 1 K4 a
    step, the NetCDF record read back, finite fields and land at rest.
    Then the script's own step (``coupled_ice_loop`` with the run's
    restoring dict, chunks of 10) replayed from the run's graph against
    the host loop over two chunks, bit for bit (the graph reads the
    restoring targets by address), and K1-K4 against their plain versions
    on the operands of one of its steps at this width."""
    import shutil

    from gb25_tpu_torch.data.netcdf import read_netcdf
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.models.atmosphere import data_free_atmosphere
    from gb25_tpu_torch.models.coupled import OceanIceState, _ice_pair_step, coupled_ice_loop
    from gb25_tpu_torch.models.hydrostatic import premask_state
    from gb25_tpu_torch.scripts import ocean_climate_simulation as script

    out = os.path.join(SMOKE_OUT, "climate")
    shutil.rmtree(out, ignore_errors=True)
    kernels = climate_kernels()
    argv = ["--resolution", str(PRODUCTION_RESOLUTION), "--Nz", str(NZ), "--grid", "tripolar",
            "--dt", str(DT), "--sea-ice", "slab", "--output-format", "netcdf", "--output-dir",
            out, "--stop-days", repr(PRODUCTION_STEPS * DT / 86400.0), "--device", DEVICE]
    print(f"[40] the run script in process: python -m gb25_tpu_torch.scripts."
          f"ocean_climate_simulation {' '.join(argv)}")
    gc.collect()
    torch.cuda.empty_cache()
    for k in kernels.values():
        k.launches = 0
    device_loop.STATS.reset()
    t0 = time.perf_counter()
    sim, parts = script.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = device_loop.STATS
    if sim.iteration != PRODUCTION_STEPS:
        raise AssertionError(f"the run stopped at iteration {sim.iteration}")
    if stats.eager_steps != 1 or stats.replayed_steps != PRODUCTION_STEPS - 1:
        raise AssertionError(f"a full chunk ran from the host: {stats.eager_steps} eager steps, "
                             f"{stats.replayed_steps} replayed (only the Euler step may run "
                             "eagerly)")
    launches = hold_launches("[40]", kernels, CLIMATE_PER_STEP, PRODUCTION_STEPS)
    record = {"eager_steps": stats.eager_steps, "replayed_steps": stats.replayed_steps,
              "captures": stats.captures, "replays": stats.replays,
              "pool_gb": stats.pool_bytes / 1e9}
    ms_step = 1e3 * sim.run_wall_time / PRODUCTION_STEPS
    grid, state, ice = sim.grid, sim.state, parts["ice"]
    ccfg, atmos, restoring = parts["ccfg"], parts["atmos"], parts["restoring"]

    # the profiler over one more full chunk (replayed) and one host step
    chunk = script.INNER_STEPS
    seen, method = probe_chunk(lambda: sim._step_fn(sim.cfg, grid, state, sim.dt, chunk + 1),
                               CLIMATE_PER_STEP, chunk + 1, chunk)
    print(f"  profiler probe over {chunk + 1} steps: {seen} ({method})")

    # the script's own step from the run's last state: two chunks replayed
    # from the graph the run captured, against the host loop
    def step_n(pair, n):
        return OceanIceState(*coupled_ice_loop(ccfg, grid, atmos, pair.ocean, pair.ice, DT, n,
                                               restoring=restoring, chunk=chunk))

    host_step = functools.partial(_ice_pair_step, ccfg, grid, atmos, dt=DT, restoring=restoring,
                                  premasked=True)

    def host_n(pair, n):
        return device_loop.host_loop(host_step, OceanIceState(premask_state(grid, pair.ocean),
                                                              pair.ice), n)

    pair = OceanIceState(state, ice)
    host_ms = loop_vs_host("run script, restoring and slab ice", step_n, host_n, pair, ms_step,
                           n=2 * chunk)
    if stats.captures != 0 or stats.replays != 2 or stats.eager_steps != 0:
        raise AssertionError(f"the script's step did not replay the run's graph: {stats.captures} "
                             f"captures, {stats.replays} replays, {stats.eager_steps} eager steps")
    ops = capture_step_operands(lambda: host_step(pair))
    checks = production_kernels(ops)

    nc = read_netcdf(os.path.join(out, "surface.nc"))[0]
    if list(nc["time"]) != [0.0] or nc["T_surface"].shape != (1, grid.Nx, grid.Ny):
        raise AssertionError(f"unexpected NetCDF record: time {nc['time']}, "
                             f"T_surface {nc['T_surface'].shape}")
    if not all(np.isfinite(nc[k]).all() for k in ("u_surface", "v_surface", "T_surface",
                                                  "S_surface", "eta", "lon", "lat")):
        raise AssertionError("non-finite values in the NetCDF record")
    print(f"  NetCDF record read back: {sorted(nc)}, T_surface in "
          f"[{nc['T_surface'].min():.3f}, {nc['T_surface'].max():.3f}] degC")
    check_climate_state(state, grid, (grid.Nz, grid.Ny, grid.Nx))
    if not (float(ice.v.min()) >= 0.0 and 0.0 <= float(ice.a.min()) <= float(ice.a.max()) <= 1):
        raise AssertionError("ice out of bounds")
    atmos_gather = data_free_atmosphere(grid, pre_regrid=False)
    terms = time_production_terms(grid, atmos, atmos_gather, ops["increments"], state, ice, ccfg)
    del ops
    cells = grid.Nx * grid.Ny * grid.Nz
    print(f"  [40] Simulation.run {grid.Nx}x{grid.Ny}x{grid.Nz} on {card}: {ms_step:.3f} ms/step "
          f"({cells * PRODUCTION_STEPS / sim.run_wall_time:.4e} cell-steps/s; "
          f"{PRODUCTION_STEPS} steps, progress {PRODUCTION_STEPS // 10} times, the NetCDF record, "
          f"{record['captures']} captures), from the host {host_ms:.3f} ms/step, "
          f"the call {wall:.1f} s with the set-up; [13] the islands tripolar climate "
          f"{NX}x{NY}x{NZ} replayed {trip_ms:.3f} ms/step "
          f"({NX * NY * NZ / (1e-3 * trip_ms):.4e} cell-steps/s)")
    shutil.rmtree(out, ignore_errors=True)
    return {"ms_step": ms_step, "host_ms_step": host_ms, "launches": launches, "loop": record,
            "probe": seen, "probe_method": method, "terms": terms, "kernels": checks,
            "shape": [grid.Nx, grid.Ny, grid.Nz]}


def seeded_cold(grid, state):
    """``state`` with T = -2.2 degC poleward of 60 degrees, and an ice cover
    v = 1 m, a = 0.9 poleward of 70 degrees on wet columns: from the
    data-free start the surface stays above freezing, so the ice would run
    on zeros."""
    from gb25_tpu_torch.models.seaice import SeaIceState

    phi = (grid.phi2_c if grid.north_fold else grid.phi_c_i.reshape(-1, 1).expand(grid.Ny,
                                                                                   grid.Nx)).abs()
    T = torch.where(phi[None] > 60.0, torch.full_like(state.tracers["T"], -2.2),
                    state.tracers["T"])
    cover = ((phi > 70.0) & (grid.bottom_height < 0.0)).to(grid.dtype)
    return (state.replace(tracers={**state.tracers, "T": T}),
            SeaIceState(v=1.0 * cover, a=0.9 * cover), phi)


def prognostic_ice(card, trip_ms):
    """[41]: the slab ice at full width on the islands tripolar grid
    (1536x768x64), from the seeded polar cold, through ``coupled_ice_loop``:
    the main path's launches and profiler probe, the device loop against
    the host loop bit for bit on ocean, ice, clock and iteration, the ice's
    bounds, none on land or equatorward of 40 degrees, growth in the cold
    band."""
    from gb25_tpu_torch import coupled_ice_loop, data_free_ocean_climate_model
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.models.coupled import OceanIceState, _ice_pair_step
    from gb25_tpu_torch.models.hydrostatic import premask_state

    print(f"[41] the prognostic slab ice at {NX}x{NY}x{NZ} (islands tripolar, CATKE), "
          "T = -2.2 degC poleward of 60 degrees, v = 1 m, a = 0.9 poleward of 70")
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=RESOLUTION, Nz=NZ, device=DEVICE, grid_type="gaussian_islands_tripolar",
        sea_ice="slab")
    state, ice, phi = seeded_cold(grid, state)
    v0 = ice.v.clone()

    def step_n(pair, n):
        return OceanIceState(*coupled_ice_loop(ccfg, grid, atmos, pair.ocean, pair.ice, DT, n))

    def host_n(pair, n):
        step = functools.partial(_ice_pair_step, ccfg, grid, atmos, dt=DT, premasked=True)
        return device_loop.host_loop(step, OceanIceState(premask_state(grid, pair.ocean),
                                                         pair.ice), n)

    s, elapsed, launches, _, loop_rec = run_main_path(step_n, OceanIceState(state, ice),
                                                      climate_kernels(), CLIMATE_PER_STEP,
                                                      ICE_STEPS)
    ms_step = 1e3 * elapsed / ICE_STEPS
    host_ms = loop_vs_host("slab ice", step_n, host_n, s, ms_step)
    check_climate_state(s.ocean, grid)
    v, a = s.ice.v, s.ice.a
    land = grid.bottom_height == 0.0
    band = (phi > 60.0) & (phi < 70.0) & ~land
    growth = float((v - v0)[band].max())
    checks = {"v_min": float(v.min()), "a_min": float(a.min()), "a_max": float(a.max()),
              "v_on_land": float(v[land].abs().max()), "v_below_40": float(v[phi < 40.0].max()),
              "growth_in_band": growth, "cover_cells": int((a > 0.15).sum())}
    print(f"  ice after {s.iteration} steps: {checks}")
    if (checks["v_min"] < 0 or checks["a_min"] < 0 or checks["a_max"] > 1
            or checks["v_on_land"] != 0 or checks["v_below_40"] != 0 or growth <= 0):
        raise AssertionError(f"the ice is out of bounds or did not grow: {checks}")
    print(f"  [41] slab ice {NX}x{NY}x{NZ} on {card}: {ms_step:.3f} ms/step replayed "
          f"({NX * NY * NZ * ICE_STEPS / elapsed:.4e} cell-steps/s), from the host "
          f"{host_ms:.3f} ms/step; [13] without the ice {trip_ms:.3f} ms/step")
    return {"ms_step": ms_step, "host_ms_step": host_ms, "launches": launches,
            "loop": loop_rec, "checks": checks}


def kill_and_resume(card):
    """[42]: the port's run_10day --phase all at 1536x768x64, dt = 60 s,
    over RUN10_DAYS days (144 steps, the checkpoint at step 72) as three
    subprocesses on this card; fails unless the resumed state equals the
    uninterrupted one bit for bit on all 15 fields."""
    import shutil

    out = os.path.join(SMOKE_OUT, "run10day")
    report = os.path.join(SMOKE_OUT, "run10day.json")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(SMOKE_OUT, exist_ok=True)
    free_gb = shutil.disk_usage(SMOKE_OUT).free / 1e9
    cmd = [sys.executable, "-m", "gb25_tpu_torch.scripts.run_10day", "--phase", "all",
           "--nx", str(NX), "--nz", str(NZ), "--dt", str(DT), "--days", str(RUN10_DAYS),
           "--out", out, "--json-out", report, "--device", DEVICE]
    print(f"[42] kill and resume: {' '.join(cmd[1:])} ({free_gb:.0f} GB free on the disk)")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=ROOT)
        wall = time.perf_counter() - t0
        if r.returncode != 0 or not os.path.exists(report):
            raise AssertionError(f"run_10day failed ({r.returncode}):\n{r.stdout[-3000:]}\n"
                                 f"{r.stderr[-3000:]}")
        with open(report) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    comp = res["comparison"]
    if not comp["bitwise_equal"] or comp["n_fields"] != 15:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {comp}")
    phases = {p: {k: res[p][k] for k in ("iteration", "ms_per_step",
                                         "ms_per_step_without_checkpoints",
                                         "checkpoint_write_s", "eager_steps", "replayed_steps",
                                         "process_s")} for p in ("full", "interrupt", "resume")}
    for p, r_ in phases.items():
        print(f"  {p}: to iteration {r_['iteration']}, {r_['ms_per_step']:.3f} ms/step with the "
              f"checkpoints, {r_['ms_per_step_without_checkpoints']:.3f} without; checkpoint "
              f"writes {', '.join(f'{t:.2f}' for t in r_['checkpoint_write_s'])} s; "
              f"{r_['eager_steps']} eager, {r_['replayed_steps']} replayed steps; the process "
              f"{r_['process_s']:.1f} s")
    print(f"  [42] on {card}: bitwise_equal {comp['bitwise_equal']} on {comp['n_fields']} "
          f"fields; {wall:.1f} s in all")
    return {"phases": phases, "comparison": comp, "wall_s": wall}


def production_phases(card, trip_ms):
    """[40]-[42]; returns their records."""
    t0 = time.perf_counter()
    run = production_run(card, trip_ms)
    gc.collect()
    torch.cuda.empty_cache()
    ice = prognostic_ice(card, trip_ms)
    gc.collect()
    torch.cuda.empty_cache()
    resume = kill_and_resume(card)
    print(f"  [40]-[42] {time.perf_counter() - t0:.1f} s")
    return {"run_script": run, "seaice": ice, "kill_resume": resume}


# --------------------------------------------------------------------------
# the flagship's own entry points: the run scripts, the correctness
# protocol, the eddy probe
# --------------------------------------------------------------------------

RUN_SCRIPT_STEPS = 64   # [43], [44]: each script's two loops
CORRECTNESS_LOOP = 100  # [45]: the protocol's last loop, as the script's main runs it
EDDY_1DEG = dict(nx=360, ny=160, nz=8, dt=900.0, steps=1920, chunk=96)  # [46] (a)
# [46] (a): the days its EKE must stay finite. The closure-free run goes
# non-finite late, at a day that float32 rounding moves: on the CPU from the
# port's initial state both packages at day 17, from JAX's the port at day
# 19 and JAX not in 20 days; in float64 they agree to day 20
# (tests/test_torch_eddy_witness.py). The fit window ends near day 10.
EDDY_1DEG_FINITE_DAYS = 16
EDDY_BALANCED = dict(nx=NX, ny=NY, nz=NZ, dt=90.0, steps=960, chunk=96, init="balanced",
                     noise=1e-5)  # [46] (b)
SCRIPT_LABELS = ("compile first_time_step", "compile loop", "first time step", "first loop",
                 "second loop")


def run_quietly(main, argv):
    """``main(argv)`` with its output printed, each allocator-stats line
    (a whole ``torch.cuda.memory_stats`` dict) cut to its first 100
    characters."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return main(argv)
    finally:
        for line in buf.getvalue().splitlines():
            print(line[:100] + " ..." if "allocator" in line and len(line) > 100 else line)


def zero_counts(kernels):
    from gb25_tpu_torch.models import device_loop

    gc.collect()
    torch.cuda.empty_cache()
    for k in kernels.values():
        k.launches = 0
    device_loop.STATS.reset()


def loop_record():
    from gb25_tpu_torch.models import device_loop

    stats = device_loop.STATS
    return {"eager_steps": stats.eager_steps, "replayed_steps": stats.replayed_steps,
            "captured_steps": stats.captured_steps, "captures": stats.captures,
            "replays": stats.replays, "pool_gb": stats.pool_bytes / 1e9}


def serial_run_script(card, flag_ms, k6_ms):
    """[43]: the port's serial run script's main in this process at
    1536x768x64 with 64-step loops, on the K1 route and with --kernels
    pallas: its five phase times, the launches a step over the run (the
    compile phase's step on a copy, the Euler step, 2 x 64 replayed) and
    under the profiler over one more replayed block and a host step, and
    its final state bit for bit against the same 1 + 2 x 64 steps launched
    from the host."""
    from gb25_tpu_torch.models import baroclinic_instability_state, device_loop, loop, time_step
    from gb25_tpu_torch.models.hydrostatic import loop_step
    from gb25_tpu_torch.scripts import baroclinic_instability_run as script

    steps = RUN_SCRIPT_STEPS
    base = ["--grid-x", str(NX), "--grid-y", str(NY), "--grid-z", str(NZ), "--steps", str(steps),
            "--device", DEVICE]
    kernels = k6_kernels()
    out = {}
    for route, extra, ref_ms in (("auto", [], flag_ms), ("pallas", ["--kernels", "pallas"], k6_ms)):
        argv = base + extra
        print(f"[43] the serial run script in process: python -m gb25_tpu_torch.scripts."
              f"baroclinic_instability_run {' '.join(argv)}")
        zero_counts(kernels)
        res = run_quietly(script.main, argv)
        cfg, grid, s = res["cfg"], res["grid"], res["state"]
        if list(res["times"]) != list(SCRIPT_LABELS):
            raise AssertionError(f"[43] phase labels {list(res['times'])}")
        if route == "auto":
            per_step = {"K1": 1, "K2": 1, "K6": 0, "K5": 0}
        else:
            per_step = {"K6": 1, "K5": k5_per_step(cfg, grid), "K1": 0, "K2": 0}
        # the compile phase's warm step on a copy, the Euler step, 2 x steps
        launches = hold_launches(f"[43] {route}", kernels, per_step, 2 + 2 * steps)
        rec = loop_record()
        if rec["eager_steps"] != 2 or rec["captures"] != 1:
            raise AssertionError(f"[43] {route}: {rec} (one capture, in the compile phase, and "
                                 "two eager steps expected)")
        check_state(s, (NZ, NY, NX))
        s0 = baroclinic_instability_state(grid, tracers=cfg.tracers)
        host = device_loop.host_loop(loop_step(cfg, grid, DT), time_step(cfg, grid, s0, DT),
                                     2 * steps)
        ta, tb = device_loop._tensors(s), device_loop._tensors(host)
        differ = [f for f in ta if not torch.equal(ta[f], tb[f])]
        if differ or s.iteration != host.iteration:
            raise AssertionError(f"[43] {route}: the script's final state differs from the host "
                                 f"loop's in {differ} (iteration {s.iteration} vs "
                                 f"{host.iteration})")
        del host, s0
        seen, method = probe_chunk(lambda: loop(cfg, grid, s, DT, PROBE_STEPS), per_step,
                                   PROBE_STEPS, PROBE_STEPS - 1)
        times = res["times"]
        ms_step = 1e3 * times["second loop"] / steps
        print(f"  bit for bit with 1 + 2 x {steps} steps from the host in {len(ta)} tensors; "
              f"profiler probe {seen} ({method})")
        print(f"  [43] {route} on {card}: " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
              + f"; second loop {ms_step:.3f} ms/step ({NX * NY * NZ / (1e-3 * ms_step):.4e} "
              f"cell-steps/s); the main path's loop {ref_ms:.3f} ms/step")
        out[route] = {"times": times, "ms_step": ms_step, "launches": launches,
                      "steps": 2 + 2 * steps, "loop": rec, "probe": seen,
                      "probe_method": method}
        del res, s, grid
    return out


def sharded_run_script(card):
    """[44]: the port's sharded run script on a group of one rank at tile
    1536x768x64, 64-step loops at dt 1 s, with --save-dir: the phase times,
    K1 and K2 once a step, and the dumps read back bit for bit into the
    final state."""
    import shutil

    from gb25_tpu_torch.io import restore_state
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.scripts import sharded_baroclinic_instability_run as script

    steps = RUN_SCRIPT_STEPS
    save = os.path.join(SMOKE_OUT, "sharded")
    shutil.rmtree(save, ignore_errors=True)
    argv = ["--tile-x", str(NX), "--tile-y", str(NY), "--Nz", str(NZ), "--steps", str(steps),
            "--dt", "1", "--save-dir", save, "--device", DEVICE]
    print(f"[44] the sharded run script on a group of one rank: python -m gb25_tpu_torch."
          f"scripts.sharded_baroclinic_instability_run {' '.join(argv)}")
    kernels = k6_kernels()
    zero_counts(kernels)
    try:
        res = run_quietly(script.main, argv)
        s = res["state"]
        launches = hold_launches("[44]", kernels, {"K1": 1, "K2": 1, "K6": 0, "K5": 0},
                                 2 + 2 * steps)
        rec = loop_record()
        check_state(s, (NZ, NY, NX))
        back = restore_state(s, save, mesh=res["mesh"])
        ta, tb = device_loop._tensors(s), device_loop._tensors(back)
        differ = [f for f in ta if not torch.equal(ta[f], tb[f].to(ta[f].device))]
        if differ or back.iteration != s.iteration:
            raise AssertionError(f"[44] the dumps read back differ in {differ}")
        dumped = sum(os.path.getsize(os.path.join(save, f)) for f in os.listdir(save))
    finally:
        shutil.rmtree(save, ignore_errors=True)
    times = res["times"]
    ms_step = 1e3 * times["second loop"] / steps
    print(f"  the dumps ({dumped / 1e9:.2f} GB) read back bit for bit in {len(ta)} tensors")
    print(f"  [44] on {card}: " + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; second loop {ms_step:.3f} ms/step at dt 1 s")
    return {"times": times, "ms_step": ms_step, "launches": launches, "steps": 2 + 2 * steps,
            "loop": rec, "dump_gb": dumped / 1e9}


def correctness_run(card):
    """[45]: the correctness protocol at 1536x768x64 f32 (dt 1e-9 s, noise
    1e-3, the 100-step loop): the serial model (K1, K2) against the
    decomposed model forced onto the 1x1 tile ("local": K1, K5, no K2) at
    f32's rtol at all five checkpoints; each field's largest relative
    difference printed."""
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid
    from gb25_tpu_torch.models import baroclinic_instability_config, baroclinic_instability_state
    from gb25_tpu_torch.models import device_loop
    from gb25_tpu_torch.parallel import make_mesh
    from gb25_tpu_torch.scripts.correctness_baroclinic_instability_run import protocol
    from gb25_tpu_torch.utils.correctness import default_rtol

    rtol = default_rtol(torch.float32)
    print(f"[45] the correctness protocol at {NX}x{NY}x{NZ} f32: serial against the decomposed "
          f"model forced onto the 1x1 tile ('local'), rtol {rtol:.3e}, dt 1e-9 s, loop "
          f"{CORRECTNESS_LOOP}")
    kernels = k6_kernels()
    cfg = baroclinic_instability_config()
    grid = simple_latitude_longitude_grid(NX, NY, NZ, device=DEVICE)
    state = baroclinic_instability_state(grid, noise_velocity=1e-3, tracers=cfg.tracers)
    zero_counts(kernels)
    t0 = time.perf_counter()
    with open(os.devnull, "w") as quiet, contextlib.redirect_stdout(quiet):  # per-field lines
        checkpoints = protocol(make_mesh(), cfg, grid, state, 1e-9, CORRECTNESS_LOOP, "local")
    wall = time.perf_counter() - t0
    stats = device_loop.STATS
    steps = 11 + CORRECTNESS_LOOP
    k5 = k5_per_step(cfg, grid)
    launches = {k: stats.launches(kern) for k, kern in kernels.items()}
    want = {"K1": 2 * steps, "K2": steps, "K6": 0, "K5": k5 * steps}
    if launches != want:
        raise AssertionError(f"[45] launches on the device {launches}, expected {want}")
    out = {}
    for name, report, _ in checkpoints:
        rel = {f: (err / ref if ref else err) for f, ref, err, _ in report}
        out[name] = rel
        print(f"  {name}: largest relative difference " + ", ".join(
            f"{f} {r:.3e}" for f, r in rel.items()))
    print(f"  [45] on {card}: all five checkpoints within rtol {rtol:.3e}; launches {launches} "
          f"({steps} steps each model); {wall:.1f} s")
    return {"checkpoints": out, "launches": launches, "steps": steps, "rtol": rtol,
            "wall_s": wall}


def eddy_probe(card):
    """[46]: the eddy probe (a) in the JAX package's validated 1-degree
    configuration, held to tests/test_eddy_statistics.py:82-91's band and
    finite to day ``EDDY_1DEG_FINITE_DAYS``, and
    (b) on the balanced jet at 1536x768x64 (dt 90 s, noise 1e-5, 960
    steps): EKE finite and growing from its first sample (no adjustment
    dip), the fit printed beside docs/EDDY_VALIDATION.json's
    quarter_degree_balanced record; K1 and K2 once a step."""
    from gb25_tpu_torch.scripts import eddy_statistics

    kernels = k6_kernels()
    per_step = {"K1": 1, "K2": 1, "K6": 0, "K5": 0}
    out = {}
    for key, kw in (("one_degree", EDDY_1DEG), ("balanced", EDDY_BALANCED)):
        print(f"[46] the eddy probe ({key}): python -m gb25_tpu_torch.scripts.eddy_statistics "
              + " ".join(f"--{k} {v}" for k, v in kw.items()))
        zero_counts(kernels)
        t0 = time.perf_counter()
        res = eddy_statistics.run(**kw, device=DEVICE)
        wall = time.perf_counter() - t0
        launches = hold_launches(f"[46] {key}", kernels, per_step, res["steps_run"])
        rec = loop_record()
        eke = np.asarray(res["eke"])
        summary = {k: res[k] for k in ("sigma_fit_per_s", "fit_r2", "sigma_ratio",
                                       "eke_growth_factor", "fit_window", "sigma_eady_per_s")}
        print(f"  EKE {eke[0]:.4e} -> {eke[-1]:.4e} over {res['times_days'][-1]:.2f} days "
              f"({len(eke)} chunks); {summary}; {wall:.1f} s, {1e3 * wall / res['steps_run']:.3f} "
              "ms/step with the diagnostics")
        chunks = kw["steps"] // kw["chunk"]
        finite = len(eke) == chunks  # run() drops a non-finite tail
        # the day of the first chunk whose EKE is not finite (run() stops there)
        breakdown_day = None if finite else res["steps_run"] * kw["dt"] / 86400.0
        finite_days = res["times_days"][-1] if len(eke) else 0.0
        print(f"  {len(eke)} of {chunks} chunks with a finite EKE, to day {finite_days:.2f}; "
              + ("finite to the end" if finite else f"non-finite at day {breakdown_day:.2f}"))
        if key == "one_degree":
            # the JAX test's band (its run() too drops a non-finite tail),
            # and a finite run to EDDY_1DEG_FINITE_DAYS, which the band
            # cannot see
            band = (res["eke_growth_factor"] > 3.0 and res["fit_r2"] > 0.9
                    and 0.1 < res["sigma_ratio"] < 1.2)
            if not band:
                raise AssertionError(f"[46] (a) outside the band EKE growth > 3, r2 > 0.9, "
                                     f"0.1 < sigma_fit / sigma_Eady < 1.2: {summary}")
            if finite_days < EDDY_1DEG_FINITE_DAYS:
                raise AssertionError(f"[46] (a) EKE finite to day {finite_days:.2f} only, "
                                     f"non-finite at day {breakdown_day:.2f} (at least "
                                     f"{EDDY_1DEG_FINITE_DAYS} days expected)")
        else:
            if not finite or int(np.argmin(eke)) != 0 or not eke[-1] > eke[0]:
                raise AssertionError(f"[46] (b) EKE goes non-finite, dips below its first "
                                     f"sample or does not grow: {eke}")
            with open(os.path.join(ROOT, "docs", "EDDY_VALIDATION.json")) as f:
                ref = json.load(f)["quarter_degree_balanced"]
            print(f"  beside docs/EDDY_VALIDATION.json quarter_degree_balanced ({ref['steps']} "
                  f"steps, {ref['times_days'][-1]:.2f} days): sigma_fit "
                  f"{ref['sigma_fit_per_s']:.4e} /s, r2 {ref['fit_r2']:.4f}, EKE growth "
                  f"{ref['eke_growth_factor']:.4e}; this run's first {len(eke)} chunks: sigma_fit "
                  f"{res['sigma_fit_per_s']:.4e} /s, r2 {res['fit_r2']:.4f}, EKE growth "
                  f"{res['eke_growth_factor']:.4e}")
        print(f"  [46] {key} on {card}: launches {launches} over {res['steps_run']} steps "
              f"({rec['eager_steps']} eager, {rec['replayed_steps']} replayed)")
        out[key] = {**summary, "eke": res["eke"], "times_days": res["times_days"], "finite": finite,
                    "finite_chunks": len(eke), "chunks": chunks, "finite_days": finite_days,
                    "breakdown_day": breakdown_day, "launches": launches, "steps": res["steps_run"], "loop": rec, "wall_s": wall}
    return out


def entry_point_phases(card, flag_ms, k6_ms):
    """[43]-[46]; returns their records."""
    t0 = time.perf_counter()
    serial = serial_run_script(card, flag_ms, k6_ms)
    sharded = sharded_run_script(card)
    gc.collect()
    torch.cuda.empty_cache()
    correct = correctness_run(card)
    gc.collect()
    torch.cuda.empty_cache()
    eddy = eddy_probe(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [43]-[46] {time.perf_counter() - t0:.1f} s")
    return {"serial": serial, "sharded": sharded, "correctness": correct, "eddy": eddy}


# --------------------------------------------------------------------------
# the last of the JAX package's surface: K6's float64 instance, a float64
# state on the K6 route, paired-bfloat16 limbs ([47])
# --------------------------------------------------------------------------

F64_FLOP_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores
F64_STEPS = 16          # [47] (b)'s timed loops
BF16X2_BLOCK = 2        # [47] (c), (d): steps a captured graph holds
CLIMATE_BF16X2_NZ = 8   # [47] (d)'s depth


def k6_f64_case(label, cfg, grid, ue, ve, tr_e):
    """One K6 float64 instance on ``ue``, ``ve``, ``tr_e``, f and the grid
    cast to float64: one launch, float64 outputs bit for bit with the plain
    twin; the kernel alone and the twin timed, launch shape, spills and
    bound (8-byte values, the FP64 rate)."""
    from gb25_tpu_torch.ops import pallas_tendency as k6
    from gb25_tpu_torch.ops.operators import coriolis_ff

    f64 = torch.float64
    args = (dataclasses.replace(cfg, kernels="pallas"), grid.cast(f64),
            coriolis_ff(grid, cfg.coriolis).to(f64), ue.to(f64), ve.to(f64),
            {k: c.to(f64) for k, c in tr_e.items()})
    before = k6.KERNEL.launches
    got = k6.pallas_tendencies(*args)
    want = k6.pallas_tendencies_plain(*args)
    torch.cuda.synchronize()
    if k6.KERNEL.launches != before + 1:
        raise AssertionError(f"K6 {label}: {k6.KERNEL.launches - before} launches")
    pairs = [("Gu", got[0], want[0]), ("Gv", got[1], want[1])]
    pairs += [("G" + k, got[2][k], want[2][k]) for k in tr_e]
    if any(g.dtype != f64 for _, g, _ in pairs):
        raise AssertionError(f"K6 {label}: outputs not float64")
    errs = [compare(n, g, w, 0.0, 0.0) for n, g, w in pairs]
    del got, want, pairs
    ms = cuda_time_ms(lambda: k6.tendency_kernel(*args), reps=10)
    plain_ms = cuda_time_ms(lambda: k6.pallas_tendencies_plain(*args), reps=1, warmup=0)
    ntr = len(tr_e)
    info = k6.kernel_info(ntr, "all", grid.north_fold, general=True, dtype=f64)
    b = k6_bound(args[0], grid, ntr, value_bytes=8)
    spills = spills_of(k6.KERNEL, k6_key(ntr, 0, grid.north_fold, dtype="d"))
    print(f"  K6 {label}: bit for bit; alone {ms:.3f} ms; plain {plain_ms:.3f} ms; spills "
          f"(stores, loads) {spills}; " + launch_line(info, b))
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "bitwise": True, "launch": info, "spills": spills}


def k6_f64_instances():
    """[47] (a): K6's float64 instances at 1536x768x64 on
    ``precision_fields``' operands."""
    from gb25_tpu_torch.ops.eos import LinearEquationOfState

    out = {}
    for geometry, cases in (("flat", ((1, None), (2, None), (2, "linear"), (4, None))),
                            ("tripolar", ((3, None), (4, None)))):
        cfg_all, grid, ue, ve, tr_all = precision_fields(geometry)
        for ntr, eos in cases:
            cfg, tr_e = with_tracers(cfg_all, tr_all, ntr)
            if eos == "linear":
                cfg = dataclasses.replace(cfg, eos=LinearEquationOfState())
            label = (f"f64 {geometry} {ntr} tracer{'s' if ntr > 1 else ''}"
                     + (" linear eos" if eos else ""))
            out[label] = k6_f64_case(label, cfg, grid, ue, ve, tr_e)
            gc.collect()
            torch.cuda.empty_cache()
        del cfg_all, grid, ue, ve, tr_all
        gc.collect()
        torch.cuda.empty_cache()
    return out


def float64_k6_route(card):
    """[47] (b): a float64 flagship state on kernels="pallas": K6's float64
    instance once a step, K2-K5's plain versions (the JAX package's gates
    send float64 to its array code)."""
    from gb25_tpu_torch import baroclinic_instability_model, loop, time_step

    cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                    dtype=torch.float64, kernels="pallas")
    moved = loop(cfg, grid, state, DT, WARMUP)
    step = functools.partial(time_step, cfg, grid, dt=DT)

    def plain_step(st):
        with plain_versions():
            return step(st)

    a, b = fields_of(step(moved)), fields_of(plain_step(moved))
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        raise AssertionError(f"[47] (b): the float64 K6 route differs from its plain path in "
                             f"{differ}")
    # the 'torch' route sums each column's b dz by torch's reduction, the K6
    # route by the running sum: p = csum - total cancels ~300 m^2/s^2, so Gu
    # and Gv part by up to ~2e-11 of their largest value (64 float64 ulps of
    # p over the cell); every other field within 1e-12
    c = fields_of(time_step(dataclasses.replace(cfg, kernels="torch"), grid, moved, DT))
    for name in a:
        rel = 1e-10 if name in ("Gu", "Gv") else 1e-12
        compare(f"f64 {name}", a[name], c[name], 0.0, rel * float(c[name].abs().max()))
    del a, b, c
    print(f"  one step after {WARMUP}: bit for bit with the route's plain path; against the "
          "'torch' route within 1e-12 of each field's largest value, Gu and Gv within 1e-10")
    kernels = k6_kernels()
    per_step = {"K6": 1, "K5": 0, "K1": 0, "K2": 0}
    step_n = lambda st, n: loop(cfg, grid, st, DT, n)  # noqa: E731
    s, elapsed, launches, peak_gb, rec = run_main_path(step_n, moved, kernels, per_step,
                                                       F64_STEPS)
    umax = check_state(s, (NZ, NY, NX))
    ms_step = 1e3 * elapsed / F64_STEPS
    host_ms = loop_vs_host("[47] (b)", step_n, host_steps(
        functools.partial(time_step, cfg, grid, dt=DT, premasked=True), grid), s, ms_step)
    print(f"  [47] (b) float64 flagship on the K6 route {NX}x{NY}x{NZ} on {card}: {ms_step:.3f} "
          f"ms/step (timed second {F64_STEPS}-step loop, replayed), from the host {host_ms:.3f}; "
          f"max|u| {umax:.4f} m/s; peak device memory {peak_gb:.2f} GB")
    return {"ms_step": ms_step, "host_ms_step": host_ms, "steps": F64_STEPS,
            "launches": launches, "loop": rec, "peak_gb": peak_gb}


def bf16x2_row(card, label, cfg, grid, state, step, kernels, per_step):
    """[47] (c), (d): 1 + ``BF16X2_BLOCK`` steps from a device loop of
    ``BF16X2_BLOCK``-step graphs (an eager step, a capture, a replay)
    against the same steps from the host, bit for bit; the replayed
    ms/step from a second call that replays the kept graph, the host's;
    each kernel's launches a step through the wrappers over the host
    steps."""
    from gb25_tpu_torch.models import device_loop

    n = 1 + BF16X2_BLOCK
    device_loop.STATS.reset()
    a = device_loop.device_loop(step, state, n, grid.cache, block=BF16X2_BLOCK)
    torch.cuda.synchronize()
    stats = device_loop.STATS
    if (stats.captures, stats.replays) != (1, 1):
        raise AssertionError(f"{label}: {stats.captures} captures, {stats.replays} replays")
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    b = device_loop.host_loop(step, state, n)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / n
    calls = {name: k.launches for name, k in kernels.items()}
    if calls != {name: m * n for name, m in per_step.items()}:
        raise AssertionError(f"{label}: launches {calls} over {n} host steps, expected "
                             f"{per_step} a step")
    ta, tb = device_loop._tensors(a), device_loop._tensors(b)
    differ = [f for f in ta if not torch.equal(ta[f], tb[f])]
    if differ or a.iteration != b.iteration:
        raise AssertionError(f"{label}: the device loop differs from the host loop in {differ}")
    for name, f in fields_of(a).items():
        if not torch.isfinite(f).all():
            raise AssertionError(f"{label}: {name} is not finite")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_loop.device_loop(step, a, BF16X2_BLOCK, grid.cache, block=BF16X2_BLOCK)
    torch.cuda.synchronize()
    ms_step = 1e3 * (time.perf_counter() - t0) / BF16X2_BLOCK
    if device_loop.STATS.replays != 2:
        raise AssertionError(f"{label}: the timed call did not replay the kept graph")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {label} on {card}: 1 + {BF16X2_BLOCK} steps replayed bit for bit with the host "
          f"loop in {len(ta)} tensors; {ms_step:.3f} ms/step replayed, {host_ms:.3f} ms/step "
          f"from the host; launches a step {per_step} (through the wrappers, host steps); "
          f"max|u| {float(a.u.abs().max()):.4f} m/s; peak device memory {peak_gb:.2f} GB, graph "
          f"pool {stats.pool_bytes / 1e9:.2f} GB")
    return {"ms_step": ms_step, "host_ms_step": host_ms, "launches": calls,
            "steps": n, "peak_gb": peak_gb, "pool_gb": stats.pool_bytes / 1e9}


def bf16x2_rows(card):
    """[47] (c) and (d)."""
    from gb25_tpu_torch import (
        baroclinic_instability_model,
        coupled_time_step,
        data_free_ocean_climate_model,
        time_step,
    )
    from gb25_tpu_torch.models.hydrostatic import loop_step
    from gb25_tpu_torch.ops import pallas_barotropic, pallas_catke, pallas_tridiag, pallas_zslab

    rows = {}
    cfg32, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE)
    cfg = dataclasses.replace(cfg32, compute_dtype="bf16x2")
    t0 = time.perf_counter()
    precision_distance("(c) bf16x2", time_step(cfg, grid, state, DT),
                       time_step(cfg32, grid, state, DT), bounded=False)
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL}
    rows["flagship"] = bf16x2_row(card, f"(c) bf16x2 flagship {NX}x{NY}x{NZ}", cfg, grid, state,
                                  loop_step(cfg, grid, DT), kernels, {"K1": 0, "K2": 1})
    del grid, state
    gc.collect()
    torch.cuda.empty_cache()
    # the card's step against the CPU's at 64x32x8, from the same state
    _, g_cpu, s_cpu = baroclinic_instability_model(64, 32, 8, device="cpu")
    _, g_card, _ = baroclinic_instability_model(64, 32, 8, device=DEVICE)
    got = fields_of(time_step(cfg, g_card, cast_state(s_cpu, DEVICE), DT))
    want = fields_of(time_step(cfg, g_cpu, s_cpu, DT))
    for name in got:
        y = want[name].to(DEVICE)
        compare(f"(c) {name}", got[name], y, 1e-3, min(5e-6, 1e-3 * float(y.abs().max())))
    print(f"  (c) bf16x2 at 64x32x8: the card's step within [5]'s tolerances of the CPU's; "
          f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ccfg, grid, atmos, state = data_free_ocean_climate_model(
        resolution=RESOLUTION, Nz=CLIMATE_BF16X2_NZ, device=DEVICE,
        grid_type="gaussian_islands_tripolar")
    ccfg = dataclasses.replace(ccfg, ocean=dataclasses.replace(ccfg.ocean,
                                                               compute_dtype="bf16x2"))
    kernels = {"K1": pallas_zslab.KERNEL, "K2": pallas_barotropic.KERNEL,
               "K3": pallas_tridiag.KERNEL, "K4": pallas_catke.KERNEL}
    from gb25_tpu_torch.models.hydrostatic import premask_state

    state = premask_state(grid, state)
    step = functools.partial(coupled_time_step, ccfg, grid, atmos, dt=DT, premasked=True)
    rows["climate_tripolar"] = bf16x2_row(
        card, f"(d) bf16x2 CATKE tripolar climate {NX}x{NY}x{CLIMATE_BF16X2_NZ}", ccfg, grid,
        state, step, kernels, {"K1": 0, "K2": 1, "K3": 3, "K4": 1})
    print(f"  (d) {time.perf_counter() - t0:.1f} s")
    return rows


def last_surface_phases(card):
    """[47]; returns K6's float64 entry and the rows' records."""
    t0 = time.perf_counter()
    print(f"[47] (a) K6's float64 instances vs plain at {NX}x{NY}x{NZ}, bit for bit")
    k6f = k6_f64_instances()
    print(f"[47] (b) a float64 flagship state on kernels='pallas' at {NX}x{NY}x{NZ}")
    f64 = float64_k6_route(card)
    gc.collect()
    torch.cuda.empty_cache()
    print("[47] (c), (d) compute_dtype='bf16x2'")
    rows = bf16x2_rows(card)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  [47] {time.perf_counter() - t0:.1f} s")
    res = k6f["f64 flat 2 tracers"]
    e = entry("pallas_tendencies_f64", "tendencies.cu", "gb25_tpu/ops/pallas_tendency.py:115",
              "float64_flagship_k6", f64["launches"]["K6"], res,
              (res["bound_ms"], res["bound_by"]))
    e |= {"spills": res["spills"], "bitwise": True, "instances": k6f,
          **on_device(f64["loop"], "K6")}
    return e, {"float64_k6": f64, **{f"bf16x2_{k}": r for k, r in rows.items()}}


T_START = time.perf_counter()


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from gb25_tpu_torch.ops import (
        pallas_barotropic,
        pallas_catke,
        pallas_tendency,
        pallas_tridiag,
        pallas_zslab,
    )

    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built = build_kernels([pallas_zslab.KERNEL, pallas_barotropic.KERNEL, pallas_tridiag.KERNEL,
                           pallas_catke.KERNEL, pallas_catke.KEPS_KERNEL,
                           pallas_barotropic.BLOCK_KERNEL, pallas_tendency.KERNEL])
    print(f"[2] kernels built in {built:.1f} s")

    flag_kernels, flag = flagship(card)
    torch.cuda.empty_cache()
    clim_kernels, clim = climate(card, "gaussian_islands", 7)
    torch.cuda.empty_cache()
    trip_kernels, trip = climate(card, "gaussian_islands_tripolar", 12)
    torch.cuda.empty_cache()
    keps_kernels, kep = keps(card)
    torch.cuda.empty_cache()

    print(f"[19] K5 (barotropic_block) vs plain at the decomposed climate shape")
    k5 = phase_k5(torch.Generator(device=DEVICE).manual_seed(8642))
    torch.cuda.empty_cache()
    # "ring" runs on a process group of one rank, as a tile of a real
    # decomposition would on NCCL (its exchanges are copies of its own strips)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=torch.device(DEVICE, torch.cuda.current_device()))
    try:
        dclim = decomposed_climate(card, trip["ms_step"], 20)
        torch.cuda.empty_cache()
        dflag = decomposed_flagship(card, flag["ms_step"], 21)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    summary = {"flagship": flag, "climate": clim, "climate_tripolar": trip, "keps": kep}
    k6_entries, k5_on_k6, k6_ms = k6_phases(
        card, {name: r["ms_step"] for name, r in summary.items()})
    sw = shallow_water(card)
    torch.cuda.empty_cache()
    choice_entries, choices = further_choices(card, flag["ms_step"])
    print(f"[31] the K6 route on the decomposed 1x1 tripolar climate")
    dk6 = decomposed_k6(card, k6_ms["climate_tripolar_k6"]["ms_step"])
    gc.collect()
    torch.cuda.empty_cache()
    print("[32] compute_dtype='float32' on the serial flagship; a float64 state under 'auto'")
    f32 = serial_float32(card, flag["ms_step"])
    gc.collect()
    torch.cuda.empty_cache()
    print("[33] the further choices and 'float32' on the decomposed 1x1 flagship")
    tiles = tile_choices(card, {"bf16s": (choices["bf16s"]["ms_step"], 27),
                                "vertical_scalar": (choices["vertical_scalar"]["ms_step"], 28),
                                "explicit": (choices["explicit"]["ms_step"], 29),
                                "float32": (f32["ms_step"], 32)})
    gc.collect()
    torch.cuda.empty_cache()
    scheme_entries, schemes = scheme_phases(card, flag["ms_step"])
    gc.collect()
    torch.cuda.empty_cache()
    precision_entries, precision = precision_phases(card)
    gc.collect()
    torch.cuda.empty_cache()
    production = production_phases(card, trip["ms_step"])
    gc.collect()
    torch.cuda.empty_cache()
    scripts = entry_point_phases(card, flag["ms_step"], k6_ms["flagship_k6"]["ms_step"])
    gc.collect()
    torch.cuda.empty_cache()
    k6_f64_entry, last = last_surface_phases(card)

    def host(r):
        return "" if r.get("host_ms_step") is None else f", from the host {r['host_ms_step']:.3f}"

    print(f"[30] on {card}, ms/step of the timed loops (replayed from CUDA graphs; from the "
          "host where named): " + "; ".join(
              f"{name} {r['ms_step']:.3f} ({r['rate']:.4e} cell-steps/s){host(r)}, plain "
              f"{r['plain_ms_step']:.3f}" for name, r in summary.items()) + "; " + "; ".join(
        f"decomposed 1x1 {name} local {r['local']['ms_step']:.3f}{host(r['local'])}, ring "
        f"{r['ring']['ms_step']:.3f}{host(r['ring'])}" for name, r in
        (("climate_tripolar", dclim), ("flagship", dflag))) + "; K6 route: " + "; ".join(
        f"{name} {r['ms_step']:.3f}{host(r)}" for name, r in k6_ms.items())
          + f"; decomposed 1x1 K6 route climate_tripolar {dk6['ms_step']:.3f}{host(dk6)}; "
          + "; ".join(f"decomposed 1x1 {name} {r['ms_step']:.3f}{host(r)}"
                      + (f", dt {r['dt']:g} s" if r["dt"] != DT else "")
                      for name, r in tiles.items() if "ms_step" in r)
          + f"; float32 {f32['ms_step']:.3f} ({f32['rate']:.4e} cell-steps/s){host(f32)}"
          + f"; shallow water {sw['ms_step']:.3f} ({sw['rate']:.4e} cell-steps/s), from the host "
          f"{sw['host_ms_step']:.3f} ({sw['host_rate']:.4e} cell-steps/s); " + "; ".join(
              f"{name} {r['ms_step']:.3f} ({r['rate']:.4e} cell-steps/s, {r['steps']} steps"
              f"{', ' + 'x'.join(map(str, r['shape'])) if r['shape'] != [NX, NY, NZ] else ''}"
              f"{', dt %g s' % r['dt'] if r['dt'] != DT else ''}){host(r)}"
              for name, r in choices.items()) + "; " + "; ".join(
              f"{name} {r['ms_step']:.3f} ({r['rate']:.4e} cell-steps/s, {r['steps']} steps, idle "
              f"{100 * r['idle']:.1f}%){host(r)}" for name, r in schemes.items()) + "; " + "; ".join(
              f"({row}) {PRECISION_ROWS[row]} {r['ms_step']:.3f} ({r['rate']:.4e} cell-steps/s, "
              f"{r['steps']} steps){host(r)}" for row, r in precision.items())
          + f"; [40] run script Simulation.run {production['run_script']['ms_step']:.3f} "
          f"({'x'.join(map(str, production['run_script']['shape']))}, chunks of 10 replayed)"
          f"; [41] slab ice {production['seaice']['ms_step']:.3f}"
          f"{host(production['seaice'])}; [42] kill and resume, full phase "
          f"{production['kill_resume']['phases']['full']['ms_per_step']:.3f} with its "
          f"checkpoints; [43] serial run script, second loop "
          f"{scripts['serial']['auto']['ms_step']:.3f}, --kernels pallas "
          f"{scripts['serial']['pallas']['ms_step']:.3f}; [44] sharded run script on one rank "
          f"{scripts['sharded']['ms_step']:.3f} at dt 1 s; [46] eddy probe, 1 degree "
          f"{1e3 * scripts['eddy']['one_degree']['wall_s'] / scripts['eddy']['one_degree']['steps']:.3f}"
          f", balanced jet "
          f"{1e3 * scripts['eddy']['balanced']['wall_s'] / scripts['eddy']['balanced']['steps']:.3f} with "
          f"the EKE diagnostics; [47] float64 flagship on the K6 route "
          f"{last['float64_k6']['ms_step']:.3f}{host(last['float64_k6'])}; bf16x2 flagship "
          f"{last['bf16x2_flagship']['ms_step']:.3f}{host(last['bf16x2_flagship'])}; bf16x2 CATKE "
          f"tripolar climate {NX}x{NY}x{CLIMATE_BF16X2_NZ} "
          f"{last['bf16x2_climate_tripolar']['ms_step']:.3f}{host(last['bf16x2_climate_tripolar'])}"
          f" (the bf16x2 rows replayed from {BF16X2_BLOCK}-step graphs)")

    k5_entry = entry("barotropic_block", "barotropic_block.cu",
                     "gb25_tpu/ops/pallas_barotropic.py:349", "climate_tripolar_decomposed",
                     dclim["local"]["launches"]["K5"], k5["tripolar"], k5["tripolar"]["bound"])
    k5_entry.update(columns_launch=k5["columns"]["launch"])
    k5_entry.update(
        launches_ring=dclim["ring"]["launches"]["K5"],
        launches_flagship_decomposed=dflag["local"]["launches"]["K5"],
        k6_routes=k5_on_k6,
        tile_routes={"climate_tripolar_k6_decomposed": dk6["launches"]["K5"],
                     **{f"{name}_decomposed": r["launches"]["K5"] for name, r in tiles.items()
                        if "launches" in r}},
        bitwise=k5["tripolar"]["bitwise"], device_ms=k5["tripolar"]["device_ms"],
        columns={k: k5["columns"][k]
                 for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bitwise")}
        | {"bound_ms": k5["columns"]["bound"][0]})
    # K6's tripolar instance on the decomposed tile of [31], checked and timed on
    # the tile's own operands
    k6_tile = entry("pallas_tendencies_tripolar_decomposed", "tendencies.cu",
                    "gb25_tpu/ops/pallas_tendency.py:115", "climate_tripolar_k6_decomposed",
                    dk6["launches"]["K6"], dk6["k6"], dk6["k6"]["bound"])
    k6_tile.update(bitwise=dk6["k6"]["bitwise"], b_bitwise=dk6["k6"]["b_bitwise"],
                   **on_device(dk6["loop"], "K6"))
    # K1's unfused instances on the tiles of [33] and serially under "float32" ([32])
    choice_entries[0].update(
        launches_float32=f32["launches"]["K1"],
        launches_float64_state=f32["float64_state"]["operand_modes"]["float32"],
        launches_tiles={f"{n}_decomposed": tiles[n]["launches"]["K1"]
                        for n in ("explicit", "float32")})
    choice_entries[1].update(
        launches_tiles={"bf16s_decomposed": tiles["bf16s"]["launches"]["K1"]},
        launches_float64_state=f32["float64_state"]["operand_modes"]["bf16s"])
    # the K1-K4 instances of the tripolar and islands climate on the production paths
    for e, kernel in zip(trip_kernels[:2] + clim_kernels[2:4], ("K1", "K2", "K3", "K4")):
        e["production_routes"] = {
            "run_script": production["run_script"]["launches"][kernel],
            "run_script_steps": PRODUCTION_STEPS,
            "run_script_vs_plain": production["run_script"]["kernels"][kernel],
            "seaice": production["seaice"]["launches"][kernel],
            "seaice_steps": production["seaice"]["loop"]["steps"]}
    # the flagship instances' launches on the run scripts' paths ([43]-[46])
    serial, eddy = scripts["serial"], scripts["eddy"]
    correct = scripts["correctness"]
    for e, kernel in zip(flag_kernels, ("K1", "K2")):
        e["run_script_routes"] = {
            "serial_script": serial["auto"]["launches"][kernel],
            "serial_script_steps": serial["auto"]["steps"],
            "sharded_script": scripts["sharded"]["launches"][kernel],
            "sharded_script_steps": scripts["sharded"]["steps"],
            "correctness": correct["launches"][kernel],
            "correctness_steps": correct["steps"],
            **{f"eddy_{k}": eddy[k]["launches"][kernel] for k in eddy},
            **{f"eddy_{k}_steps": eddy[k]["steps"] for k in eddy},
            **{f"eddy_{k}_finite": {f: eddy[k][f] for f in ("finite_chunks", "chunks",
                                                            "breakdown_day")}
               for k in eddy}}
    k6_entries[0]["run_script_routes"] = {
        "serial_script_pallas": serial["pallas"]["launches"]["K6"],
        "serial_script_pallas_steps": serial["pallas"]["steps"]}
    k5_entry["run_script_routes"] = {
        "serial_script_pallas": serial["pallas"]["launches"]["K5"],
        "serial_script_pallas_steps": serial["pallas"]["steps"],
        "correctness_decomposed": correct["launches"]["K5"],
        "correctness_decomposed_steps": correct["steps"]}
    print(f"chip_smoke wall time {time.perf_counter() - T_START:.1f} s on {card}")
    print(json.dumps({"kernels": flag_kernels + clim_kernels + trip_kernels + keps_kernels
                      + [k5_entry] + k6_entries + [k6_tile] + choice_entries
                      + scheme_entries + precision_entries + [k6_f64_entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
