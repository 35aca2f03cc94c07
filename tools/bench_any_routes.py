"""The any-D attention and the any-P and any-shape KPConv routes on the card:
each held against its plain version at the edges of its tilings, then timed
beside its yardsticks (the plain version; SDPA for attention; the tuned P =
15 kernel for KPConv) at the shapes chip_smoke.py's phase 23 times them.

    python3 tools/bench_any_routes.py [--check | --narrow | --wide]

``--check`` builds the kernels, prints ptxas' report of the new routes and
holds them against their plain versions at the edges, without timing.
``--narrow`` times the any-shape KPConv kernel beside its plain version, f32
and bf16, at every shape the tuned kernels refuse on the port's paths
(NARROW_SHAPES: the 3DMatch encode's first layer, the 2D-3D point backbone's
level 0 at 15 and 24 kernel points, the synthetic stories' narrow layers, the
4DMatch CLI's wide K = 58 layer), on the same seeded inputs in every run
(chip_smoke.py's phase 23f holds it at its edges). ``--wide`` times the
any-shape kernel beside the tuned (P = 15) and any-P (P = 24) tensor-core
kernels at configuration C's ten wide encode layers, f32 and bf16, on the
same inputs: the any-shape kernel there comes from a second build of each
source whose C entry always takes it (``ANY_SHAPE_ONLY``).
Prints one JSON line at the end and writes it to chiprun_out/any_routes.json.
To compare two trees, run the tool from each checkout in one call. Needs one
CUDA card; reuses chip_smoke.py's data, limits and timers.
"""
import ctypes
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

# (D, B, H, L, S, offset in elements): every slice and padding edge of the
# any-D route, views offset by one element, B * H past the grid's rows, and a
# head too wide for the tensor-core branch
ATTENTION_EDGES = [(d, 4, 2, 705, 709, 0) for d in
                   (6, 54, 66, 137, 145, 176, 216, 256, 257, 264, 432, 528, 1000)]
ATTENTION_EDGES += [(54, 4, 2, 705, 709, 1), (216, 4, 2, 705, 709, 1), (128, 4, 2, 70, 45, 1),
                    (54, 8193, 8, 16, 45, 0)]
# (P, Cin, Cout): kernel points on each side of the 16-point chunks
KPCONV_EDGES = [(p, cin, cout) for p in (16, 17, 32, 33) for cin, cout in ((64, 64), (512, 512))]
KPCONV_EDGES += [(17, 128, 256), (24, 256, 128), (64, 512, 512)]


def attention_edges(gen):
    import torch

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)
    rows = []
    for bf16 in (False, True):
        kernel, plain, dtype = ((masked_attention_cuda_bf16, masked_attention_bf16_plain,
                                 torch.bfloat16) if bf16 else
                                (masked_attention_cuda, masked_attention_plain, torch.float32))
        for d, b, h, length, keys, offset in ATTENTION_EDGES:
            scale = d ** -0.5

            def draw(n):
                flat = torch.randn(n + offset, generator=gen).to("cuda", dtype)
                return flat[offset:]
            with torch.inference_mode():
                q = draw(b * h * length * d).view(b, h, length, d)
                k = draw(b * h * keys * d).view(b, h, keys, d)
                v = draw(b * h * keys * d).view(b, h, keys, d)
                mask = torch.ones(b, keys, dtype=torch.bool)
                mask[1::2, keys - 37:] = False
                mask = mask.cuda()
                before = dict(kernel.any_d_branch_launches), dict(kernel.instance_launches)
                got = kernel(q, k, v, mask, scale)
                ref = plain(q, k, v, mask, scale)
                torch.cuda.synchronize()
                branch = [n for n, c in kernel.any_d_branch_launches.items()
                          if c != before[0].get(n, 0)]
                inst = [n for n, c in kernel.instance_launches.items()
                        if c != before[1].get(n, 0)]
                err = float((got.float() - ref.float()).abs().max())
                top = float(ref.float().abs().max())
            limit = cs.ATTENTION_BF16_REL_TOL * top if bf16 else cs.ATTENTION_ABS_TOL
            ok = math.isfinite(err) and err <= limit
            rows.append({"bf16": bf16, "d": d, "shape": [b, h, length, keys], "offset": offset,
                         "instance": inst, "branch": branch, "err": err, "limit": limit,
                         "ok": ok})
            print(f"attention{' bf16' if bf16 else ''} D {d} [{b},{h},{length}x{keys}] offset "
                  f"{offset}: {inst} {branch} err {err:.3e} (limit {limit:.1e})"
                  f"{'' if ok else '  FAILED'}", flush=True)
            del q, k, v, got, ref
    return rows


def kpconv_edges(calls, gen):
    """The encode's widest layer's inputs with P, Cin, Cout set per edge."""
    import torch

    from diffreg_tpu_torch.ops.kernel_points import unit_kernel_points
    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)
    q, s, inds, x0, kp0, _, extent = max(calls, key=lambda c: c[3].shape[2] * c[0].shape[1])
    radius = float(kp0.cpu().norm(dim=1).max() / torch.from_numpy(
        unit_kernel_points(kp0.shape[0])).norm(dim=1).max())
    rows = []
    cases = [(p, cin, cout, ("linear", "sum")) for p, cin, cout in KPCONV_EDGES]
    cases += [(17, 512, 512, ("linear", "closest")), (17, 512, 512, ("gaussian", "sum"))]
    for p, cin, cout, modes in cases:
        kp = (torch.from_numpy(unit_kernel_points(p)) * radius).cuda()
        x = torch.relu(torch.randn(x0.shape[0], x0.shape[1], cin, generator=gen)).cuda()
        w = (torch.randn(p, cin, cout, generator=gen) * (1.0 / math.sqrt(p * cin))).cuda()
        for bf16 in (False, True):
            counted = kpconv_cuda_bf16 if bf16 else kpconv_cuda
            before = dict(counted.route_launches)
            with torch.inference_mode():
                if bf16:
                    got = kpconv_cuda_bf16(q, kpconv_bf16_table_aligned(s, x), inds, kp,
                                           w.to(torch.bfloat16).contiguous(), extent, *modes)
                    ref = kpconv_bf16_plain(q, s, inds, x, kp, w, extent, *modes)
                else:
                    got = kpconv_cuda(q, s, inds, x, kp, w, extent, *modes)
                    ref = kpconv(q, s, inds, x, kp, w, extent, *modes)
                torch.cuda.synchronize()
            route = [n for n, c in counted.route_launches.items() if c != before.get(n, 0)]
            scale = float(ref.abs().max())
            limit = (cs.KPCONV_BF16_REL_TOL * scale if bf16 else
                     cs.KPCONV_REL_TOL * max(scale, 1.0))
            if modes[1] == "closest":
                err, excused = cs.held_against_plain(
                    got, ref, limit, f"kpconv P {p}", modes[1], (q, s, inds, kp, bf16),
                    cs.bf16_flip_rows(q, s, inds, x, kp, w, extent, modes) if bf16 else None)
                ok = True
            else:
                err, excused = float((got - ref).abs().max()), 0
                ok = math.isfinite(err) and err <= limit
            rows.append({"bf16": bf16, "p": p, "cin": cin, "cout": cout, "modes": modes,
                         "route": route, "err": err, "limit": limit, "excused": excused,
                         "ok": ok})
            print(f"kpconv{' bf16' if bf16 else ''} P {p} {cin}->{cout} {'/'.join(modes)}: "
                  f"{route} err {err:.3e} (limit {limit:.1e}){'' if ok else '  FAILED'}",
                  flush=True)
    return rows


# (name, pairs, queries, supports, K, Cin, Cout) of the synthetic stories'
# narrow layers (1,024 points a level, K 16; the bf16 stories' 8 pairs, the
# 2D-3D story's 4 in f32)
STORY_SHAPES = [(f"story {cin}->{cout}", b, 1024, 1024, 16, cin, cout)
                for b in (8, 4) for cin, cout in ((1, 32), (16, 16), (32, 32))]


def narrow_shapes(gen):
    """(name, KPConv inputs, dtypes) of every shape the tuned kernels refuse on
    the port's paths: the 3DMatch encode's first layer and the 2D-3D point
    backbone's level-0 layers on the inputs the models feed them (chip_smoke's
    pairs and 2D-3D split, weights from seed 0), that level at 24 kernel
    points, the stories' narrow layers and the wide K = 58 layer on seeded
    synthetic clouds."""
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.models.presets import preset_3dmatch
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.utils.config import load_yaml

    both = (False, True)
    _, batch_cpu = cs.path_data()
    batch = batch_cpu.to("cuda")
    model = DiffusionMatchingModel(preset_3dmatch(sample_steps=cs.STEPS), device="cuda", seed=0)
    shapes = [("3DMatch first layer", c, both)
              for c in cs.kpconv_layer_calls(model, lambda: model.encode(batch), KPConv)
              if c[3].shape[2] == 1]
    del model, batch
    cfg = pipeline_2d3d_config(load_yaml(os.path.join(REPO, "configs", "test", "rgbdv2.yaml")))
    with tempfile.TemporaryDirectory() as root:
        cs.write_2d3d_split(root)
        batch2 = cs.data_2d3d(root)[0].to("cuda")
    model2 = DiffReg2D3D(cfg, device="cuda", seed=0)
    level0, seen = [], set()
    for c in cs.kpconv_layer_calls(model2, lambda: model2.pcd_backbone(batch2), KPConvBias):
        key = (c[0].shape[1], c[1].shape[1], c[2].shape[2], c[3].shape[2], c[5].shape[2])
        if key[2] > cs.KPCONV_K_TUNED or key[3] < 64:
            if key not in seen:
                seen.add(key)
                level0.append(c)
    del model2, batch2
    shapes += [("2D-3D level 0", c, both) for c in level0]
    shapes += [("2D-3D level 0 at P 24", c, both) for c in cs.shape_calls(level0, 24, gen)]
    for name, b, nq, ns, k, cin, cout in STORY_SHAPES:
        spec = dict(cs.ANY_SHAPE_BASE, b=b, nq=nq, ns=ns, k=k, cin=cin, cout=cout)
        shapes.append((name, cs.any_shape_inputs(gen, spec), (b == 8,)))
    shapes.append(("4DMatch wide K 58", cs.any_shape_inputs(gen, cs.ANY_SHAPE_WIDE), both))
    return shapes


def device_ms(fn, iters=20):
    """Milliseconds per call of the KPConv kernels ``fn`` launches, summed
    from torch.profiler's device times: below ~0.05 ms a call the events
    around a loop of launches time the host's launch path instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
                if "kpconv" in e.key)
    return total / iters / 1e3


def time_narrow(shapes):
    """Each shape's kernel (the route its C entry reported) and plain version,
    timed, with the error and the bound. Returns the records."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)
    rows = []
    for name, (q, s, inds, x, kp, w, ext), dtypes in shapes:
        for bf16 in dtypes:
            counted = kpconv_cuda_bf16 if bf16 else kpconv_cuda
            with torch.inference_mode():
                if bf16:
                    table, wb = kpconv_bf16_table_aligned(s, x), w.to(torch.bfloat16).contiguous()
                    kernel = lambda: kpconv_cuda_bf16(q, table, inds, kp, wb, ext)  # noqa: E731
                    plain = lambda: kpconv_bf16_plain(q, s, inds, x, kp, w, ext)  # noqa: E731
                else:
                    kernel = lambda: kpconv_cuda(q, s, inds, x, kp, w, ext)  # noqa: E731
                    plain = lambda: kpconv(q, s, inds, x, kp, w, ext)  # noqa: E731
                before = dict(counted.route_launches)
                got, ref = kernel(), plain()
                torch.cuda.synchronize()
                route = [r for r, n in counted.route_launches.items() if n != before.get(r, 0)]
                top = float(ref.abs().max())
                err = float((got - ref).abs().max())
                ms = cs.time_cuda(kernel, 20)
                dev_ms = device_ms(kernel)
                plain_ms = cs.time_cuda(plain, 3, warmup=1)
            bms, by = cs.bound_ms(*cs.kpconv_work(q, s, inds, x, w, bf16),
                                  cs.BF16_FLOPS_PER_S if bf16 else cs.TF32_FLOPS_PER_S)
            shape = [q.shape[0], q.shape[1], s.shape[1], inds.shape[2], x.shape[2],
                     w.shape[2], w.shape[0]]
            rows.append({"name": name, "bf16": bf16, "b_nq_ns_k_cin_cout_p": shape,
                         "route": route, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                         "bound_ms": bms,
                         "bound_by": by, "max_abs_err": err, "max_abs_plain": top})
            print(f"{name}{' bf16' if bf16 else ''} B/Nq/Ns/K/Cin/Cout/P {shape}: {route} "
                  f"kernel {ms:.4f} ms (device {dev_ms:.4f}) plain {plain_ms:.4f} ms bound "
                  f"{bms:.4f} ms ({by}); err "
                  f"{err:.3e} = {err / max(top, 1e-30):.3e} of max |plain|", flush=True)
            del got, ref
    return rows


def narrow_result(card):
    """--narrow: NARROW_SHAPES timed. Returns the JSON record."""
    import torch

    from diffreg_tpu_torch.utils.cuda import build_kernels

    t0 = time.perf_counter()
    build_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    return {"card": card, "narrow": time_narrow(narrow_shapes(torch.Generator().manual_seed(1)))}


# Each KPConv source again with its C entry always taking the any-shape
# kernel, for --wide: the source's own entry renamed out of the way, then an
# entry of the same name and signature that launches the any-shape kernel.
ANY_SHAPE_ONLY = {
    "kpconv": """#define kpconv_forward kpconv_forward_by_shape
#include "{src}"
#undef kpconv_forward
extern "C" int kpconv_forward(const float* q_pts, const float* s_pts, const int32_t* inds,
                              const float* x, const float* kp, const float* w, float* out,
                              int B, int Nq, int Ns, int K, int Cin, int Cout, int P,
                              float extent, int influence, int closest, float gauss_den,
                              int* route, cudaStream_t stream) {{
  *route = kRouteAnyShape;
  return (int)launch_any_shape(q_pts, s_pts, inds, x, kp, w, out, B, Nq, Ns, K, Cin, Cout, P,
                               Mode{{extent, gauss_den, closest != 0}}, influence, stream);
}}
""",
    "kpconv_bf16": """#define kpconv_forward_bf16 kpconv_forward_bf16_by_shape
#include "{src}"
#undef kpconv_forward_bf16
extern "C" int kpconv_forward_bf16(const float* q_pts, const __nv_bfloat16* table,
                                   const int32_t* inds, const float* kp,
                                   const __nv_bfloat16* w, float* out, int B, int Nq, int Ns,
                                   int K, int Cin, int Cout, int P, float extent, int influence,
                                   int closest, float gauss_den, int* route,
                                   cudaStream_t stream) {{
  *route = kRouteAnyShape;
  return (int)launch_any_shape_bf16(q_pts, table, inds, kp, w, out, B, Nq, Ns, K, Cin, Cout, P,
                                    Mode{{extent, gauss_den, closest != 0}}, influence, stream);
}}
""",
}


def any_shape_only_libraries():
    """Build ANY_SHAPE_ONLY's stale libraries (in parallel) into the build
    directory; returns {name: loaded library}."""
    import glob

    from diffreg_tpu_torch.utils.build import BUILD_DIR, PendingBuild, is_stale
    from diffreg_tpu_torch.utils.cuda import CSRC_DIR, NVCC_FLAGS, _nvcc

    os.makedirs(BUILD_DIR, exist_ok=True)
    headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    outs, pending = {}, []
    for name, text in ANY_SHAPE_ONLY.items():
        source = os.path.join(CSRC_DIR, f"{name}.cu")
        outs[name] = os.path.join(BUILD_DIR, f"lib{name}_any_shape_only.so")
        if is_stale(outs[name], [source, *headers, os.path.abspath(__file__)]):
            src = os.path.join(BUILD_DIR, f"{name}_any_shape_only.cu")
            with open(src, "w") as f:
                f.write(text.format(src=source))
            pending.append(PendingBuild([_nvcc(), *NVCC_FLAGS, src], outs[name]))
    for build in pending:
        build.wait(900.0)
    libs = {}
    for name, out in outs.items():
        lib = ctypes.CDLL(out)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def wide_result(card):
    """--wide: configuration C's ten wide encode layers (Cin >= 64) at P = 15
    and 24, each on the kernel its C entry picks (tuned, any-P) and on the
    any-shape kernel, f32 and bf16, timed in the order picked, any-shape,
    any-shape, picked (the mean of each pair), each held against the plain
    version. Returns the JSON record."""
    import torch

    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)
    from diffreg_tpu_torch.utils import cuda as cuda_util
    from diffreg_tpu_torch.utils.config import build_pipeline_config
    from diffreg_tpu_torch.utils.cuda import build_kernels

    t0 = time.perf_counter()
    build_kernels()
    forced = any_shape_only_libraries()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    picked = {name: cuda_util.kernel_library(name) for name in forced}
    gen = torch.Generator().manual_seed(0)
    _, batch_cpu = cs.path_data()
    batch = batch_cpu.to("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cfg = build_pipeline_config(cs.shape_yaml(REPO, tmp, "C")[1])
    model = DiffusionMatchingModel(cfg, device="cuda", seed=0)
    calls = [c for c in cs.kpconv_layer_calls(model, lambda: model.encode(batch), KPConv)
             if c[3].shape[2] >= 64]
    del model
    rows = []
    for p in (15, 24):
        for q, s, inds, x, kp, w, ext in cs.shape_calls(calls, p, gen):
            for bf16 in (False, True):
                name = "kpconv_bf16" if bf16 else "kpconv"
                counted = kpconv_cuda_bf16 if bf16 else kpconv_cuda
                with torch.inference_mode():
                    if bf16:
                        table, wb = kpconv_bf16_table_aligned(s, x), w.to(torch.bfloat16)
                        kernel = lambda: kpconv_cuda_bf16(q, table, inds, kp, wb, ext)  # noqa: E731
                        ref = kpconv_bf16_plain(q, s, inds, x, kp, w, ext)
                    else:
                        kernel = lambda: kpconv_cuda(q, s, inds, x, kp, w, ext)  # noqa: E731
                        ref = kpconv(q, s, inds, x, kp, w, ext)
                    top = float(ref.abs().max())
                    limit = (cs.KPCONV_BF16_REL_TOL * top if bf16 else
                             cs.KPCONV_REL_TOL * max(top, 1.0))
                    row = {"p": p, "bf16": bf16, "b_nq_ns_k_cin_cout": [
                        q.shape[0], q.shape[1], s.shape[1], inds.shape[2], x.shape[2],
                        w.shape[2]], "limit": limit}
                    times = {}
                    for which in ("picked", "any_shape", "any_shape", "picked"):
                        cuda_util._LIBS[name] = forced[name] if which == "any_shape" \
                            else picked[name]
                        before = dict(counted.route_launches)
                        err = float((kernel() - ref).abs().max())
                        torch.cuda.synchronize()
                        row[f"{which}_route"] = [r for r, n in counted.route_launches.items()
                                                 if n != before.get(r, 0)]
                        row[f"{which}_err"] = err
                        times.setdefault(which, []).append(cs.time_cuda(kernel, 20))
                    cuda_util._LIBS[name] = picked[name]
                row.update({f"{k}_ms": sum(v) / len(v) for k, v in times.items()})
                row["ok"] = all(math.isfinite(row[f"{k}_err"]) and row[f"{k}_err"] <= limit
                                for k in times)
                rows.append(row)
                print(f"P {p}{' bf16' if bf16 else ''} {row['b_nq_ns_k_cin_cout']}: "
                      f"{row['picked_route']} {row['picked_ms']:.4f} ms, "
                      f"{row['any_shape_route']} {row['any_shape_ms']:.4f} ms; err "
                      f"{row['picked_err']:.3e} / {row['any_shape_err']:.3e} (limit "
                      f"{limit:.1e}){'' if row['ok'] else '  FAILED'}", flush=True)
    sums = {f"P{p}_{'bf16' if bf16 else 'f32'}": {
        k: sum(r[f"{k}_ms"] for r in rows if r["p"] == p and r["bf16"] == bf16)
        for k in ("picked", "any_shape")} for p in (15, 24) for bf16 in (False, True)}
    for key, rec in sums.items():
        print(f"{key}, ten layers: picked {rec['picked']:.4f} ms, any-shape "
              f"{rec['any_shape']:.4f} ms ({rec['any_shape'] / rec['picked']:.3f}x)", flush=True)
    return {"card": card, "wide": rows, "sums": sums}


def routes_result(card, check_only):
    """The any-D and any-P routes at their edges and, without ``check_only``,
    timed. Returns (the JSON record, the failed edges)."""
    import torch

    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16
    from diffreg_tpu_torch.utils.config import build_pipeline_config
    from diffreg_tpu_torch.utils.cuda import build_kernels

    t0 = time.perf_counter()
    report = build_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for name, rep in report.items():
        lines = rep["log"].splitlines()
        for i, line in enumerate(lines):
            if "any_d_tc" in line or "tc_any_p" in line:
                for more in lines[i:i + 4]:
                    if "Compiling" in more or "Used" in more or "spill" in more:
                        print(f"  {name}: {more.strip()}", flush=True)
    gen = torch.Generator().manual_seed(0)
    spec, batch_cpu = cs.path_data()
    batch = batch_cpu.to("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = {n: build_pipeline_config(cs.shape_yaml(REPO, tmp, n)[1]) for n in ("C", "W")}
    model = DiffusionMatchingModel(cfgs["C"], device="cuda", seed=0)
    calls = cs.kpconv_layer_calls(model, lambda: model.encode(batch), KPConv)
    del model
    result = {"card": card, "attention_edges": attention_edges(gen),
              "kpconv_edges": kpconv_edges(calls, gen)}
    failed = [r for r in result["attention_edges"] + result["kpconv_edges"] if not r["ok"]]
    if not check_only:
        timed = {}
        for bf16 in (False, True):
            tag = "bf16" if bf16 else "f32"
            for n in ("C", "W"):
                entry = cs.check_attention(batch, cfgs[n], gen, f" ({n})", bf16)
                timed[f"attention_{tag}_{n}"] = {k: entry[k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")}
            for p in (15, 24, 64):
                for k in (kpconv_cuda, kpconv_cuda_bf16):
                    k.route_launches = {}
                entry, _ = cs.check_kpconv(cs.shape_calls(calls, p, gen), 11,
                                           "one encode (11 calls)", f" (P {p})", bf16,
                                           flip_excuse=True)
                timed[f"kpconv_{tag}_P{p}"] = {k: entry[k] for k in (
                    "ms", "plain_ms", "bound_ms", "max_abs_err")}
                timed[f"kpconv_{tag}_P{p}"]["routes"] = dict(
                    (kpconv_cuda_bf16 if bf16 else kpconv_cuda).route_launches)
        records = cs.shape_range_attention(gen)
        for tag in ("f32", "bf16"):
            for rec in records[tag]:
                if rec["d"] in (256, 528):
                    timed[f"attention_{tag}_D{rec['d']}_{rec['l']}"] = rec
        result["timed"] = timed
        for key, rec in timed.items():
            print(key, json.dumps(rec), flush=True)
    return result, failed


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_any_routes: CUDA is not available", file=sys.stderr)
        return 1
    check_only = "--check" in sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if "--narrow" in sys.argv[1:]:
        result, failed = narrow_result(card), []
    elif "--wide" in sys.argv[1:]:
        result = wide_result(card)
        failed = [r for r in result["wide"] if not r["ok"]]
    else:
        result, failed = routes_result(card, check_only)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "any_routes.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps({"failed": len(failed)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
