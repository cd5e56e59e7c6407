"""Variants of the tendency kernels K1 and K6, built side by side from
copies of ``gb25_tpu_torch/csrc`` and timed on the same operands at
1536x768x64 f32 on one GPU.

    python3 tendency_variants.py [--reps 10]

A variant sets other values of the level tile's constants in the copy's
``tendency_tile.cuh`` (the tile's rows ``kTY``, the levels of the
shared-memory ring ``kStages``, the blocks per SM its registers must allow
``kMinBlocks``) or builds K1 under ``-fmad=false`` (K6 always is). Each
copy and its libraries go to ``gb25_tpu_torch/_build/variants/``; the
package's own sources and builds are not touched. Every K1 and K6 instance
(flagship, lat-lon islands climate, tripolar climate, k-epsilon; K6 has no
islands instance) runs each variant on one set of operands: the mean of
``--reps`` launches by CUDA events, the variants timed in order and again
in reverse order, beside each build's registers, shared memory per block
and blocks per SM, and its outputs against the default build's (bit for
bit, or the largest difference). The last line is a JSON object of every
number. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import re
import shutil
import subprocess
from unittest import mock

import torch

from gb25_tpu_torch.ops import pallas_tendency, pallas_zslab
from gb25_tpu_torch.utils import cuda_build

NX, NY, NZ = 1536, 768, 64
DEVICE = "cuda"
# name -> (tile constants, K1 flags, K6 flags); None: the variant does not apply
VARIANTS = {
    "32x8": ({}, (), ()),  # the sources as they are: 32 x 8, two levels, 3 blocks per SM
    "mb1": ({"kMinBlocks": 1}, (), ()),
    "mb2": ({"kMinBlocks": 2}, (), ()),
    "mb4": ({"kMinBlocks": 4}, (), ()),
    "32x4": ({"kTY": 4, "kMinBlocks": 6}, (), ()),  # 80 registers, as the default
    "32x16": ({"kTY": 16, "kMinBlocks": 1}, (), ()),
    "ring3": ({"kStages": 3}, (), ()),
    "nofma": ({}, ("-fmad=false",), None),
}
KERNELS = {"K1": pallas_zslab, "K6": pallas_tendency}  # each module's KERNEL is swapped


def variant_sources(name, constants, source="tendency_tile.cuh"):
    """A copy of the sources with the constants of ``source`` set; its
    directory."""
    out = cuda_build.BUILD_DIR / "variants" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, out)
    path = out / source
    text = path.read_text()
    for const, value in constants.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"{source} defines {const} {n} times, expected once")
    path.write_text(text)
    return out


def build(kernel, src_dir, flags):
    """Compile ``kernel``'s source in ``src_dir`` with ``flags`` added;
    returns the library, the compiler's report and the flags."""
    flags = (*kernel.extra_flags, *flags)
    lib = src_dir / f"lib{src_dir.name}-{kernel.source.removesuffix('.cu')}.so"
    proc = subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
                           str(lib), str(src_dir / kernel.source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src_dir / kernel.source}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr, flags


def builds():
    """{"K1": {name: CudaKernel}, "K6": {...}} of every variant, compiled in
    parallel; each a CudaKernel of its own (its own launch count)."""
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        for name, (constants, f1, f6) in VARIANTS.items():
            src_dir = variant_sources(name, constants)
            for kname, flags in (("K1", f1), ("K6", f6)):
                if flags is not None:
                    jobs[kname, name] = pool.submit(build, KERNELS[kname].KERNEL, src_dir, flags)
    out = {"K1": {}, "K6": {}}
    for (kname, name), job in jobs.items():
        lib, log, flags = job.result()
        kernel = KERNELS[kname].KERNEL
        variant = cuda_build.CudaKernel(kernel.source, kernel.functions, flags)
        with mock.patch.object(cuda_build, "build_library", return_value=(lib, log)):
            variant.load()
        out[kname][name] = variant
    return out


def cuda_ms(fn, reps):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def flat(out):
    res = []
    for x in out:
        if isinstance(x, dict):
            res += list(x.values())
        elif isinstance(x, (tuple, list)):
            res += flat(x)
        else:
            res.append(x)
    return res


def instances(gen):
    """Yield (label, cfg, grid, ue, ve, tr_e, prev, face_bottoms) of each
    model instance, built one at a time."""
    from gb25_tpu_torch import baroclinic_instability_model, data_free_ocean_climate_model
    from gb25_tpu_torch.grids.immersed import face_bottom_planes, face_masks
    from gb25_tpu_torch.models.keps import TKEDissipationVerticalDiffusivity
    from gb25_tpu_torch.ops.halos import extend_field

    for label in ("flagship", "climate", "tripolar", "keps"):
        if label in ("climate", "tripolar"):
            grid_type = "gaussian_islands" if label == "climate" else "gaussian_islands_tripolar"
            ccfg, grid, _, state = data_free_ocean_climate_model(
                resolution=384 / NX, Nz=NZ, device=DEVICE, grid_type=grid_type)
            cfg = ccfg.ocean
        else:
            closure = TKEDissipationVerticalDiffusivity() if label == "keps" else None
            cfg, grid, state = baroclinic_instability_model(NX, NY, NZ, device=DEVICE,
                                                            closure=closure)

        def noise(s):
            return s * torch.randn(grid.shape, generator=gen, device=DEVICE)

        # currents of ~0.05 m/s, a T perturbation, TKE (and eps) near the start state
        tr = dict(state.tracers)
        tr["T"] = tr["T"] + noise(0.1)
        if label != "flagship":
            tr["e"] = 1e-5 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE))
        if label == "keps":
            tr["eps"] = 1e-8 * (1.0 + torch.rand(grid.shape, generator=gen, device=DEVICE))
        ue = extend_field(grid, state.u + noise(0.05), "u")
        ve = extend_field(grid, state.v + noise(0.05), "v")
        fb = None
        if grid.immersed:
            um, vm = face_masks(grid)
            ue, ve = ue * um, ve * vm
            fb = face_bottom_planes(grid)
        tr_e = {k: extend_field(grid, c, "c") for k, c in tr.items()}
        Gv_p = noise(1e-7)
        Gv_p[:, 0, :] = 0.0
        prev = (noise(1e-7), Gv_p, {k: noise(1e-7) for k in tr_e})
        yield label, cfg, grid, ue, ve, tr_e, prev, fb


def measure(module, variants, run, info, reps):
    """Time ``run`` with each variant as ``module.KERNEL``, in order and in
    reverse order; compare each variant's outputs with the first one's."""
    res = {}
    ref = None
    for name, kernel in variants.items():
        with mock.patch.object(module, "KERNEL", kernel):
            out = flat(run())
            torch.cuda.synchronize()
            ref = out if ref is None else ref
            res[name] = {"bitwise": all(torch.equal(a, b) for a, b in zip(out, ref)),
                         "max_diff": max(float((a - b).abs().max()) for a, b in zip(out, ref)),
                         "info": info(), "ms": []}
        del out
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            with mock.patch.object(module, "KERNEL", variants[name]):
                res[name]["ms"].append(cuda_ms(run, reps))
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tendency_variants: no CUDA device")
    from gb25_tpu_torch.ops.operators import coriolis_ff

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    variants = builds()
    for kname, ks in variants.items():
        for name, k in ks.items():
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {kname} {name}: {line.strip()}")

    ab = (float(torch.tensor(60.0 * 1.6, dtype=torch.float32)),
          float(torch.tensor(60.0 * -0.6, dtype=torch.float32)))
    results = {"card": card, "K1": {}, "K6": {}}
    gen = torch.Generator(device=DEVICE).manual_seed(97531)
    for label, cfg, grid, ue, ve, tr_e, prev, fb in instances(gen):
        ntr, m2 = len(tr_e), grid.north_fold
        be, b_total = pallas_zslab.column_buoyancy(cfg, grid, tr_e)
        results["K1"][label] = measure(
            pallas_zslab, variants["K1"],
            lambda: pallas_zslab.zslab_kernel(cfg, grid, ue, ve, tr_e, be, b_total, prev, ab, fb),
            lambda: pallas_zslab.kernel_info(ntr, fb is not None, m2), args.reps)
        del be, b_total
        if label != "climate":  # K6 runs on the flagship, tripolar and k-epsilon grids
            f_ff = coriolis_ff(grid, cfg.coriolis).to(torch.float32)
            results["K6"][label] = measure(
                pallas_tendency, variants["K6"],
                lambda: pallas_tendency.tendency_kernel(cfg, grid, f_ff, ue, ve, tr_e),
                lambda: pallas_tendency.kernel_info(ntr, "all", m2), args.reps)
        for kname in ("K1", "K6"):
            for name, r in results[kname].get(label, {}).items():
                info = r["info"]
                print(f"  {kname} {label:8s} {name:6s} ms {r['ms'][0]:.3f} {r['ms'][1]:.3f}  "
                      f"bit for bit with 32x8 {r['bitwise']} (max diff {r['max_diff']:.2e})  "
                      f"registers {info['registers']} smem {info['smem_bytes']} B "
                      f"tile {info['tile']} blocks/SM {info['blocks_per_sm']}", flush=True)
        del cfg, grid, ue, ve, tr_e, prev, fb
        torch.cuda.empty_cache()
    print(json.dumps(results))


if __name__ == "__main__":
    main()
