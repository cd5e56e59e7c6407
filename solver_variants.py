"""Variants of the implicit-solve kernel K3 and the blocked barotropic
kernel K5, built side by side from copies of ``gb25_tpu_torch/csrc`` and
timed on the main paths' operands on one GPU.

    python3 solver_variants.py [--reps 10]

K3 (``csrc/implicit_diffusion.cu``): the warps a block ``kWarps`` (32
columns each) and the levels its ring of copies holds in flight
``kStages``, on the three kinds of
solve at 1536x768x64 f32: a pair of fields (u, v or T, S), one field with
its decay rate (CATKE's e) and one without (k-epsilon's e and eps). A
climate step runs two pairs and one damped solve, a k-epsilon step two
pairs and two single solves. K5 (``csrc/barotropic_block.cu``): the
substeps a launch ``kS`` (the widest apron) and the staged tile (``kSX``
columns by ``kBY`` x ``kCY`` rows), on the
decomposed W = 30 block (828 x 1596 planes; tripolar metric planes with
masks, and lat-lon metric columns) and on the K6 route's W = 4 blocks of 4
and 2 substeps (776 x 1544 planes; metric columns, and metric planes with
masks).

A variant sets other values of these constants in a copy of the sources
(``tendency_variants.variant_sources``); each copy and its libraries go to
``gb25_tpu_torch/_build/variants/``, and the package's own sources and
builds are not touched. Each instance runs every variant on one set of
operands: the mean device time of ``--reps`` calls of the kernel's wrapper
by CUDA events, queued behind a sleeping kernel so that the host's cost
does not enter (K5: one block, all its launches), the variants timed in
order and
again in reverse order, beside each build's registers, shared memory per
block and blocks per SM, and whether its outputs equal the plain
version's bit for bit. The last line is a JSON object of every number.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import subprocess
from unittest import mock

import torch

from gb25_tpu_torch.ops import pallas_barotropic, pallas_tridiag
from gb25_tpu_torch.utils import cuda_build
from tendency_variants import build, variant_sources

NX, NY, NZ = 1536, 768, 64
DEVICE = "cuda"
DT = 60.0
# name -> constants of implicit_diffusion.cu; the first: the sources as they are
K3_VARIANTS = {f"c{32 * w}s{st}": {"kWarps": w, "kStages": st}
               for w, st in ((1, 8), (1, 2), (1, 4), (1, 16), (2, 8), (2, 16), (4, 8), (4, 16))}
# name -> constants of barotropic_block.cu: s<kS>_<staged columns>x<staged rows>
# (64x32t4: 256 threads of 8 rows; 64x64 spills under its 128-register cap)
_TILES = {"64x32": {"kSX": 64, "kBY": 8, "kCY": 4}, "32x32": {"kSX": 32, "kBY": 8, "kCY": 4},
          "64x32t4": {"kSX": 64, "kBY": 4, "kCY": 8}, "64x64": {"kSX": 64, "kBY": 8, "kCY": 8}}
K5_VARIANTS = {"s6_32x32": {}}
K5_VARIANTS.update({f"s{s}_{tile}": {"kS": s, **_TILES[tile]} for s in (3, 4, 5, 6, 8, 10)
                    for tile in ("64x32", "32x32", "64x32t4") if (s, tile) != (6, "32x32")})
K5_VARIANTS["s10_64x64"] = {"kS": 10, **_TILES["64x64"]}
MODULES = {"K3": (pallas_tridiag, "KERNEL", "implicit_diffusion.cu", K3_VARIANTS),
           "K5": (pallas_barotropic, "BLOCK_KERNEL", "barotropic_block.cu", K5_VARIANTS)}


def builds():
    """{"K3": {name: CudaKernel}, "K5": {...}} of every variant, compiled in
    parallel; each a CudaKernel of its own (its own launch count)."""
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        for kname, (module, attr, source, variants) in MODULES.items():
            kernel = getattr(module, attr)
            for name, constants in variants.items():
                src_dir = variant_sources(f"{kname}_{name}", constants, source)
                jobs[kname, name] = pool.submit(build, kernel, src_dir, ())
    out = {"K3": {}, "K5": {}}
    for (kname, name), job in jobs.items():
        lib, log, flags = job.result()
        module, attr, _, _ = MODULES[kname]
        kernel = getattr(module, attr)
        variant = cuda_build.CudaKernel(kernel.source, kernel.functions, flags)
        with mock.patch.object(cuda_build, "build_library", return_value=(lib, log)):
            variant.load()
        out[kname][name] = variant
    return out


def device_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls by CUDA events, the
    calls queued behind a sleeping kernel so that the host's cost of a call
    (a K5 block of 4 substeps takes less time on the card than its
    wrapper on the host) does not enter."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e6) * reps)  # ~1 ms a call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(kname, variants, run, want, info, reps):
    """Time ``run`` with each variant as the module's kernel, in order and
    in reverse order; hold each variant's outputs against ``want``."""
    module, attr, _, _ = MODULES[kname]
    res = {}
    for name, kernel in variants.items():
        with mock.patch.object(module, attr, kernel):
            out = run()
            torch.cuda.synchronize()
            res[name] = {"bitwise": all(torch.equal(a, b) for a, b in zip(out, want)),
                         "info": info(), "ms": []}
        del out
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            with mock.patch.object(module, attr, variants[name]):
                res[name]["ms"].append(device_ms(run, reps))
    return res


def k3_instances(gen):
    """Yield (label, fields, kappa, damping, a_lam, a_mu) of each kind of
    solve at the main paths' shape: fields ~N(0, 1) (+20 for the second),
    kappa 1e-5..1 m^2/s, a decay rate up to 1e-3 1/s, the flagship's
    vertical grid."""
    from gb25_tpu_torch.grids import simple_latitude_longitude_grid

    grid = simple_latitude_longitude_grid(NX, NY, NZ, device=DEVICE)
    hz = grid.hz
    a_lam, a_mu = pallas_tridiag.vertical_coefficients(DT, grid.dz_c[hz : hz + NZ],
                                                       grid.dz_f[hz : hz + NZ])
    shape = (NZ, NY, NX)

    def field(offset):
        return offset + torch.randn(shape, generator=gen, device=DEVICE)

    kappa = 10.0 ** (5.0 * torch.rand(shape, generator=gen, device=DEVICE) - 5.0)
    yield "pair", (field(0.0), field(20.0)), kappa, None, a_lam, a_mu
    yield "damped", (field(0.0),), kappa, 1e-3 * torch.rand(shape, generator=gen,
                                                            device=DEVICE), a_lam, a_mu
    yield "single", (field(0.0),), kappa, None, a_lam, a_mu


def k5_instances(gen):
    """Yield (label, weights, operands) of each block: the decomposed W = 30
    block and the K6 route's W = 4 blocks of 4 and 2 substeps, each with
    metric columns and with metric planes and masks, at a real block's
    magnitudes (dtau = 4 s, ~4000 m deep, ~27 km cells)."""
    from gb25_tpu_torch.models.free_surface import averaging_weights

    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=DEVICE)

    weights = averaging_weights(30)
    for W, blocks in ((30, (weights,)), (4, (weights[:4], weights[28:]))):
        Ye, Xe = NY + 2 * W, NX + 2 * W
        for planes in (True, False):
            m = (Ye, Xe) if planes else (Ye, 1)
            ops = [r((Ye, Xe), 2e-2, -1e-2), r((Ye, Xe), 2.0, -1.0), r((Ye, Xe), 2.0, -1.0),
                   r((Ye, Xe), 1.0, 5.0), r((Ye, Xe), 1.0, 5.0), r((Ye, Xe), 2e-4, -1e-4),
                   r((Ye, Xe), 2e-4, -1e-4), r(m, 5e3, 2.5e4), r(m, 5e3, 2.5e4),
                   r(m, 1e-9, 5e-9)]
            masks = ([(r((Ye, Xe), 1.0) > 0.05).float() for _ in range(2)] if planes
                     else [None, None])
            for w in blocks:
                kind = "planes+masks" if planes else "columns"
                yield f"W{W} n{len(w)} {kind}", w, (*ops, *masks)
            del ops, masks


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("solver_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    variants = builds()
    for kname, ks in variants.items():
        for name, k in ks.items():
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print(f"  {kname} {name}: {line.strip()}")

    results = {"card": card, "K3": {}, "K5": {}}
    gen = torch.Generator(device=DEVICE).manual_seed(13579)
    for label, fields, kappa, damp, a_lam, a_mu in k3_instances(gen):
        want = pallas_tridiag.implicit_diffusion_plain(fields, kappa, DT, a_lam, a_mu, damp)
        results["K3"][label] = measure(
            "K3", variants["K3"],
            lambda: pallas_tridiag.implicit_kernel(fields, kappa, DT, a_lam, a_mu, damp), want,
            lambda: pallas_tridiag.kernel_info(NZ, len(fields), damp is not None), args.reps)
        del want
    for label, weights, ops in k5_instances(gen):
        want = pallas_barotropic.barotropic_block_plain(weights, *ops)
        results["K5"][label] = measure(
            "K5", variants["K5"],
            lambda: pallas_barotropic._barotropic_block_cuda(weights, *ops), want,
            lambda: pallas_barotropic.block_info(ops[-1] is not None, ops[7].shape[1] > 1),
            args.reps)
        del want
    for kname, per in results.items():
        if kname == "card":
            continue
        for label, res in per.items():
            for name, r in res.items():
                info = r["info"]
                print(f"  {kname} {label:22s} {name:14s} ms {r['ms'][0]:.4f} {r['ms'][1]:.4f}  "
                      f"bit for bit with plain {r['bitwise']}  registers {info['registers']} "
                      f"smem {info['smem_bytes']} B tile {info['tile']} "
                      f"blocks/SM {info['blocks_per_sm']}")
    print(json.dumps(results))


if __name__ == "__main__":
    main()
