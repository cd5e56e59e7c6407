"""Variants of the implicit-solve kernel K3, the blocked barotropic
kernel K5 and the serial barotropic loop K2, built side by side from
copies of ``gb25_tpu_torch/csrc`` and timed on the main paths' operands on
one GPU.

    python3 solver_variants.py [--reps 10] [--kernels K2,K3,K5] [--k2-phases]

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
masks). K2 (``csrc/barotropic_loop.cu``): the threads of a block in y
``kTY`` and the cells a thread owns in y ``kCY`` (its tile's rows at most
kTY kCY, 128 columns), in the on-chip instance, and the kept build's L2 instance
("l2"), on the loop of 30 substeps at 1536x768 in its three instances:
metric columns (flat), metric columns and masks, tripolar metric planes
with masks and the fold; and K5's design carried over to K2, from
``k2_temporal_blocking.cu`` (repo root): ``kS`` substeps a launch on a
staged tile (``kSX`` columns by 32 rows), in the two lat-lon instances.
``--k2-phases`` also times the phases of a substep of K2's kept build
(edges, continuity, momentum, grid barrier) from ``%globaltimer`` reads
in a copy of its source.

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
import ctypes
import json
import re
import subprocess
from pathlib import Path
from unittest import mock

import torch

from gb25_tpu_torch.models.free_surface import averaging_weights
from gb25_tpu_torch.ops import pallas_barotropic, pallas_tridiag
from gb25_tpu_torch.utils import cuda_build
from gb25_tpu_torch.utils.profiling import queued_device_ms
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
# name -> constants of barotropic_loop.cu: t<kTY>c<kCY>; "l2": the kept
# build's L2 instance (the first: the sources as they are)
K2_VARIANTS = {"t8c9": {}, "l2": {}, "t12c6": {"kTY": 12, "kCY": 6},
               "t16c5": {"kTY": 16, "kCY": 5}}
# name -> constants of k2_temporal_blocking.cu (K5's design for K2, lat-lon
# only): tb_s<kS>_<staged columns>x<staged rows>
K2_BLOCKED = {"tb_s6_32x32": {}, "tb_s4_32x32": {"kS": 4}, "tb_s8_32x32": {"kS": 8},
              "tb_s6_64x32": {"kSX": 64}}
BLOCKED_KERNEL = cuda_build.CudaKernel(
    "k2_temporal_blocking.cu",
    {"k2_blocked_f32": [ctypes.c_void_p] * 17 + [ctypes.c_float] + [ctypes.c_int] * 4
     + [ctypes.c_void_p], "k2_blocked_info": [ctypes.POINTER(ctypes.c_int)]},
    extra_flags=("-fmad=false",))
MODULES = {"K3": (pallas_tridiag, "KERNEL", "implicit_diffusion.cu", K3_VARIANTS),
           "K5": (pallas_barotropic, "BLOCK_KERNEL", "barotropic_block.cu", K5_VARIANTS),
           "K2": (pallas_barotropic, "KERNEL", "barotropic_loop.cu", K2_VARIANTS)}


def builds(knames):
    """{"K3": {name: CudaKernel}, ...} of every variant of ``knames``,
    compiled in parallel; each a CudaKernel of its own (its own launch
    count)."""
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        for kname in knames:
            module, attr, source, variants = MODULES[kname]
            kernel = getattr(module, attr)
            for name, constants in variants.items():
                src_dir = variant_sources(f"{kname}_{name}", constants, source)
                jobs[kname, name] = pool.submit(build, kernel, src_dir, ())
        if "K2" in knames:
            for name, constants in K2_BLOCKED.items():
                src_dir = blocked_sources(name, constants)
                jobs["K2", name] = pool.submit(build, BLOCKED_KERNEL, src_dir, ())
    out = {kname: {} for kname in knames}
    for (kname, name), job in jobs.items():
        lib, log, flags = job.result()
        module, attr, _, _ = MODULES[kname]
        kernel = BLOCKED_KERNEL if name in K2_BLOCKED else getattr(module, attr)
        variant = cuda_build.CudaKernel(kernel.source, kernel.functions, flags)
        with mock.patch.object(cuda_build, "build_library", return_value=(lib, log)):
            variant.load()
        out[kname][name] = variant
    return out


def blocked_sources(name, constants):
    """A copy of the sources with ``k2_temporal_blocking.cu`` beside them,
    its constants set; its directory."""
    out = variant_sources(f"K2_{name}", {}, "barotropic_loop.cu")
    text = (Path(__file__).resolve().parent / BLOCKED_KERNEL.source).read_text()
    for const, value in constants.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"{BLOCKED_KERNEL.source} defines {const} {n} times")
    (out / BLOCKED_KERNEL.source).write_text(text)
    return out


def k2_blocked(kernel, eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, weights, dtau, g,
               masks=None, fold_p=None):
    """K2 by temporal blocking (lat-lon only): the planes of ``loop_planes``
    in torch, ceil(M / kS) launches of ``kernel``, the un-weighting in torch;
    K2's function on ``_barotropic_loop_cuda``'s operands."""
    if fold_p is not None:
        raise ValueError("the temporally blocked K2 has no fold")
    out = (ctypes.c_int * 1)()
    kernel.call("k2_blocked_info", out)
    planes = [t.contiguous() for t in pallas_barotropic.loop_planes(
        eta0, U0, V0, GU, GV, Hu, Hv, dyc, dxf, dxc, dyf, azc, dtau, g)]
    chunks = pallas_barotropic.launch_chunks(list(weights), out[0])
    buf = torch.empty((3 * (1 + min(2, len(chunks))),) + eta0.shape, device=eta0.device)
    acc, bufs = buf[:3].unbind(), (buf[3:6].unbind(), buf[6:9].unbind())
    cur = planes[:3]
    mask_ptrs = (None, None) if masks is None else (masks[0].data_ptr(), masks[1].data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    for i, chunk in enumerate(chunks):
        nxt = bufs[i % 2]
        kernel.launch("k2_blocked_f32", *[t.data_ptr() for t in (*cur, *nxt, *planes[3:])],
                      *mask_ptrs, *[t.data_ptr() for t in acc],
                      (ctypes.c_float * len(chunk))(*chunk), dtau, len(chunk), int(i == 0),
                      eta0.shape[1], eta0.shape[0], stream)
        cur = nxt
    return acc[0], acc[1] / dyc.reshape(-1, 1), acc[2] / dxf.reshape(-1, 1)


def k2_phases(ops_by_label, weights, dtau, g):
    """Where a substep of K2's on-chip instance goes: a copy of the source
    that reads %globaltimer at each phase boundary in thread 0 of the first
    and the last block, summed over the substeps. Returns, for each
    instance, ns a substep of the edges (and their barrier), continuity (and
    its barrier), momentum and the grid barrier in those two blocks."""
    src = variant_sources("K2_phases", {}, "barotropic_loop.cu")
    path = src / "barotropic_loop.cu"
    text = path.read_text()
    edits = [
        ("namespace {\n", "__device__ unsigned long long g_phase[2][4];\nnamespace {\n"
         "__device__ __forceinline__ unsigned long long now() {\n  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"),
        ("s_raz[r] = 1.0f / __ldg(A.azc + y0 - 1 + r);\n  }\n  grid.sync();\n",
         "s_raz[r] = 1.0f / __ldg(A.azc + y0 - 1 + r);\n  }\n  grid.sync();\n"
         "  const int rec = t == 0 ? (blockIdx.x == 0 ? 0 : blockIdx.x + 1 == gridDim.x ? 1 : -1)"
         " : -1;\n  unsigned long long ph[4] = {0, 0, 0, 0}, t0 = now(), t1, t2, t3;\n"),
        ("    __syncthreads();\n    // continuity", "    __syncthreads();\n    t1 = now();\n"
         "    ph[0] += t1 - t0;\n    // continuity"),
        ("    __syncthreads();\n    // momentum", "    __syncthreads();\n    t2 = now();\n"
         "    ph[1] += t2 - t1;\n    // momentum"),
        ("    if (m + 1 < A.M) grid.sync();\n  }\n\n  __syncthreads();",
         "    t3 = now();\n    ph[2] += t3 - t2;\n    if (m + 1 < A.M) grid.sync();\n"
         "    t0 = now();\n    ph[3] += t0 - t3;\n  }\n"
         "  if (rec >= 0)\n    for (int i = 0; i < 4; ++i) g_phase[rec][i] = ph[i];\n\n"
         "  __syncthreads();"),
    ]
    for a, b in edits:
        if text.count(a) != 1:
            raise RuntimeError(f"barotropic_loop.cu: phase anchor not found once: {a[:40]!r}")
        text = text.replace(a, b)
    text += ('\nextern "C" int k2_phases(unsigned long long* out) {\n'
             "  return static_cast<int>(cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase)));\n}\n")
    path.write_text(text)
    base = pallas_barotropic.KERNEL
    functions = {**base.functions, "k2_phases": [ctypes.c_void_p]}
    lib, log, flags = build(base, src, ())
    kernel = cuda_build.CudaKernel(base.source, functions, flags)
    with mock.patch.object(cuda_build, "build_library", return_value=(lib, log)):
        kernel.load()
    out = {}
    with mock.patch.object(pallas_barotropic, "KERNEL", kernel):
        for label, (ops, masks, pole) in ops_by_label.items():
            pallas_barotropic._barotropic_loop_cuda(*ops, weights, dtau, g, masks, pole)
            torch.cuda.synchronize()
            ns = (ctypes.c_ulonglong * 8)()
            kernel.call("k2_phases", ns)
            out[label] = {block: {name: ns[4 * b + i] / len(weights) for i, name in
                                  enumerate(("edges", "continuity", "momentum", "grid_barrier"))}
                          for b, block in enumerate(("first_block", "last_block"))}
    return out


def measure(kname, variants, run, want, info, reps):
    """Time ``run(name)`` with each variant as the module's kernel, in order
    and in reverse order; hold each variant's outputs against ``want``."""
    module, attr, _, _ = MODULES[kname]
    res = {}
    for name, kernel in variants.items():
        with mock.patch.object(module, attr, kernel):
            out = run(name)
            torch.cuda.synchronize()
            res[name] = {"bitwise": all(torch.equal(a, b) for a, b in zip(out, want)),
                         "info": info(name), "ms": []}
        del out
    for order in (list(variants), list(variants)[::-1]):
        for name in order:
            with mock.patch.object(module, attr, variants[name]):
                res[name]["ms"].append(queued_device_ms(lambda: run(name), reps))
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


def k2_instances(gen):
    """Yield (label, operands, fold column) of K2's three instances at
    1536x768 at a real step's magnitudes (dtau = 4 s, ~4000 m deep, ~27 km
    cells): eta0, U0, V0, GU, GV, Hu, Hv, the metrics dyc, dxf, dxc, dyf,
    azc (columns, or planes on the tripolar grid) and the masks or None."""
    def r(shape, scale, offset=0.0):
        return offset + scale * torch.rand(shape, generator=gen, device=DEVICE)

    plane = (NY, NX)
    for label, tripolar, masked in (("flat", False, False), ("masked", False, True),
                                    ("fold", True, True)):
        m = plane if tripolar else (NY,)
        ins = [r(plane, 2e-2, -1e-2), r(plane, 200.0, -100.0), r(plane, 200.0, -100.0),
               r(plane, 2e-3, -1e-3), r(plane, 2e-3, -1e-3), r(plane, 2e3, 3e3),
               r(plane, 2e3, 3e3)]
        metrics = [r(m, 5e3, 2.5e4) for _ in range(4)] + [r(m, 2e8, 6e8)]
        masks = [(r(plane, 1.0) > 0.05).float() for _ in range(2)] if masked else None
        yield label, (*ins, *metrics), masks, (NX // 3 + 7 if tripolar else None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--kernels", default="K2,K3,K5",
                    help="comma-separated kernels to vary (K2, K3, K5)")
    ap.add_argument("--k2-phases", action="store_true",
                    help="also time the phases of a K2 substep in its kept build")
    args = ap.parse_args()
    knames = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("solver_variants: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(f"card: {card}")
    variants = builds(knames)
    for kname, ks in variants.items():
        for name, k in ks.items():
            for line in k.build_log.splitlines():
                if "registers" in line or "spill" in line or "stack" in line:
                    print(f"  {kname} {name}: {line.strip()}")

    results = {"card": card, **{kname: {} for kname in knames}}
    gen = torch.Generator(device=DEVICE).manual_seed(13579)
    for label, fields, kappa, damp, a_lam, a_mu in (k3_instances(gen) if "K3" in knames else ()):
        want = pallas_tridiag.implicit_diffusion_plain(fields, kappa, DT, a_lam, a_mu, damp)
        results["K3"][label] = measure(
            "K3", variants["K3"],
            lambda _: pallas_tridiag.implicit_kernel(fields, kappa, DT, a_lam, a_mu, damp), want,
            lambda _: pallas_tridiag.kernel_info(NZ, len(fields), damp is not None), args.reps)
        del want
    for label, weights, ops in (k5_instances(gen) if "K5" in knames else ()):
        want = pallas_barotropic.barotropic_block_plain(weights, *ops)
        results["K5"][label] = measure(
            "K5", variants["K5"],
            lambda _: pallas_barotropic._barotropic_block_cuda(weights, *ops), want,
            lambda _: pallas_barotropic.block_info(ops[-1] is not None, ops[7].shape[1] > 1),
            args.reps)
        del want
    weights = averaging_weights(30)
    dtau, g = float(torch.tensor(4.0, dtype=torch.float32)), 9.80665
    k2_ops = {}
    for label, ops, masks, pole in (k2_instances(gen) if "K2" in knames else ()):
        want = pallas_barotropic.loop_plain(*ops, weights, dtau, g, masks, pole)
        if args.k2_phases:
            k2_ops[label] = (ops, masks, pole)

        def info(name, masks=masks, pole=pole):
            if name in K2_BLOCKED:
                out = (ctypes.c_int * 1)()
                variants["K2"][name].call("k2_blocked_info", out)
                return {"registers": 0, "smem_bytes": 0, "tile": [0, 0], "blocks_per_sm": 0,
                        "substeps": out[0], "launches": -(-30 // out[0])}
            on_chip = name != "l2"
            plan = pallas_barotropic.launch_plan(NX, NY, masks is not None, pole is not None,
                                                 on_chip)
            i = pallas_barotropic.loop_info(masks is not None, pole is not None)
            return {**i, "plan": plan, "tile": plan.get("tile", [0, 0]),
                    "smem_bytes": plan.get("smem_bytes", 0)}

        def run(name, ops=ops, masks=masks, pole=pole):
            if name in K2_BLOCKED:
                return k2_blocked(variants["K2"][name], *ops, weights, dtau, g, masks)
            return pallas_barotropic._barotropic_loop_cuda(*ops, weights, dtau, g, masks, pole,
                                                           on_chip=name != "l2")

        # the temporally blocked K2 has no fold
        kept = {k: v for k, v in variants["K2"].items() if pole is None or k not in K2_BLOCKED}
        results["K2"][label] = measure("K2", kept, run, want, info, args.reps)
        del want
    if k2_ops:
        results["K2_phases"] = k2_phases(k2_ops, weights, dtau, g)
        for label, blocks in results["K2_phases"].items():
            for block, ns in blocks.items():
                print(f"  K2 phases {label:7s} {block:11s} ns a substep: " + ", ".join(
                    f"{k} {v:.0f}" for k, v in ns.items()))
        del k2_ops
    for kname, per in results.items():
        if kname in ("card", "K2_phases"):
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
