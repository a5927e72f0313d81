"""Time the port's depthwise forward kernel under other plans than its own.

    python3 scripts/torch_depthwise_sweep.py [--old-source OLD.cu] [--out LOG]

Needs a CUDA card and nvcc. At each of MobileNetV2's 10 depthwise shapes
(batch 8 and 128, bf16) it times, with chip_smoke.py's clock (median of
CUDA-event intervals, L2 flushed before each): ``F.conv2d`` on the same
tensors, the kernel under ``forward_plan``'s plan, the same plan with one
tile a block (a grid of all the tiles, no persistent blocks), and the
kernel under the chunks, band heights, thread counts and grids around
it (every one is logged; the best six are printed).
``--old-source`` also builds a depthwise source of an earlier revision
(one whose forward took no plan: ``tpunet_depthwise3x3_fwd(x, w, y, n,
h, wd, c, stride, dtype, vectorised, stream)``) with the same nvcc
flags, checks it against the plain version and times it beside the
others. One JSON object a line; the last lines sum each time over the 17
layers of a forward.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--old-source", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_depthwise_sweep: no CUDA device", file=sys.stderr)
        return 1
    from tpunet_torch.ops import _build
    from tpunet_torch.ops import depthwise as dw

    out = open(args.out, "w") if args.out else None

    def emit(**fields):
        line = json.dumps(fields)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    fn = dw._kernel()
    emit(card=cs.card_line(), ptxas={
        cs.kernel_label(k): v for k, v in _build.resources("depthwise").items()
        if "fwd" in k})
    old = None
    if args.old_source:
        lib = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR)) / "libold.so"
        built = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                                str(lib), str(args.old_source)],
                               capture_output=True, text=True)
        if built.returncode:
            print(built.stdout + built.stderr, file=sys.stderr)
            return 1
        old = ctypes.CDLL(str(lib)).tpunet_depthwise3x3_fwd
        old.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_void_p])
        old.restype = ctypes.c_int

    def out_like(x, s):
        n, h, wd, c = x.shape
        return torch.empty((n, (h - 1) // s + 1, (wd - 1) // s + 1, c),
                           dtype=x.dtype, device=x.device)

    def run(x, w, s, chunk, rows, threads, blocks):
        y = out_like(x, s)
        call = dw.FwdCall(*x.shape, s, chunk, rows, threads, blocks,
                          dw._DTYPE_CODES[x.dtype])
        err = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                 ctypes.addressof(call), 1,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, (err, tuple(x.shape), s, chunk, rows, threads,
                          blocks)
        return y

    def run_old(x, w, s):
        y = out_like(x, s)
        err = old(x.data_ptr(), w.data_ptr(), y.data_ptr(), *x.shape, s,
                  dw._DTYPE_CODES[x.dtype], 1,
                  torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return y

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    keys = ["bound_ms", "library_ms", "kernel_ms", "one_tile_a_block_ms"]
    keys += ["old_ms"] if old else []
    rows_out = {8: [], 128: []}
    gen = torch.Generator().manual_seed(cs.SEED)
    for (h, c, s), layers in cs.MAIN_SHAPES.items():
        for n in (8, 128):
            x = torch.randn(n, h, h, c, generator=gen).cuda().bfloat16()
            w = torch.randn(3, 3, c, generator=gen).cuda().bfloat16()
            xl = x.permute(0, 3, 1, 2)
            wl = w.permute(2, 0, 1).unsqueeze(1).contiguous()
            plan = dw.forward_plan(n, h, h, c, s, 2, sms)
            y = dw.depthwise_conv3x3(x, w, s)
            row = {"shape": [n, h, h, c, s], "layers": layers,
                   "plan": plan._asdict(),
                   "bound_ms": cs.dw_fwd_bound(x, w, y)["bound_ms"],
                   "library_ms": cs.time_ms(torch, lambda: F.conv2d(
                       xl, wl, stride=s, padding=1, groups=c)),
                   "kernel_ms": cs.time_ms(
                       torch, lambda: dw.depthwise_conv3x3(x, w, s)),
                   "one_tile_a_block_ms": cs.time_ms(torch, lambda: run(
                       x, w, s, plan.chunk, plan.rows, plan.threads,
                       plan.tiles))}
            if old:
                check = run_old(x, w, s)
                torch.cuda.synchronize()
                assert torch.equal(check, y), "the old source disagrees"
                row["old_ms"] = cs.time_ms(torch, lambda: run_old(x, w, s))
            ho = (h - 1) // s + 1
            tried = {}
            for chunk in range(16, 65, 8):
                if c % chunk:
                    continue
                pairs = chunk // 2
                unit = pairs * 32 // math.gcd(pairs, 32)
                tile = plan.in_cols * chunk * 2
                for per_sm, budget in ((3, 72 * 1024), (2, 110 * 1024)):
                    fits = [r for r in range(1, min(ho, 16) + 1)
                            if 2 * -(-(r + 2 if s == 1 else 2 * r + 1)
                                     * tile // 128) * 128 <= budget]
                    if not fits:
                        continue
                    for r in {fits[-1], max(1, fits[-1] // 2),
                              max(1, fits[-1] // 4)}:
                        r = -(-ho // -(-ho // r))
                        chunks = c // chunk
                        tiles = n * -(-ho // r) * chunks
                        grid = min(tiles, per_sm * sms // chunks * chunks)
                        for threads in {unit * max(1, 128 // unit),
                                        unit * max(1, 256 // unit)}:
                            for blocks in (grid, tiles):
                                key = (f"c{chunk}_r{r}_t{threads}"
                                       f"_b{blocks}")
                                if key not in tried:
                                    tried[key] = cs.time_ms(
                                        torch, lambda: run(
                                            x, w, s, chunk, r, threads,
                                            blocks), reps=10, warmup=2)
            row["variants"] = tried
            row["best"] = sorted(tried.items(), key=lambda kv: kv[1])[:6]
            rows_out[n].append(row)
            emit(**{k: v for k, v in row.items() if k != "variants"})
            if out:
                out.write(json.dumps({"shape": row["shape"],
                                      "variants": row["variants"]}) + "\n")
            del x, w, y, xl, wl
    for n, rows in rows_out.items():
        emit(batch=n, per_forward={k: sum(r[k] * r["layers"] for r in rows)
                                   for k in keys})
    return 0


if __name__ == "__main__":
    sys.exit(main())
