"""The any-D attention and any-P KPConv routes on the card: each held against
its plain version at the edges of its tilings, then timed beside its
yardsticks (the plain version; SDPA for attention; the tuned P = 15 kernel
for KPConv) at the shapes chip_smoke.py's phase 23 times them.

    python3 tools/bench_any_routes.py [--check]

``--check`` builds the kernels, prints ptxas' report of the new routes and
holds them against their plain versions at the edges, without timing.
Prints one JSON line at the end and writes it to chiprun_out/any_routes.json.
Needs one CUDA card; reuses chip_smoke.py's data, limits and timers.
"""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_any_routes: CUDA is not available", file=sys.stderr)
        return 1
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16
    from diffreg_tpu_torch.utils.config import build_pipeline_config
    from diffreg_tpu_torch.utils.cuda import build_kernels

    check_only = "--check" in sys.argv[1:]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
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
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "any_routes.json"), "w") as f:
        json.dump(result, f)
    print(json.dumps({"failed": len(failed)}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
