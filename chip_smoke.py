"""Drive the PyTorch port (tpunet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs a CUDA card and nvcc

Phases, each of which must pass:
  1. build every kernel under tpunet_torch/csrc with nvcc;
  2. hold each kernel against its plain PyTorch version at the main
     path's shapes (MobileNetV2's 10 depthwise shapes at 224 px, batch 8)
     plus odd cases, and time kernel, plain version, the library call and
     the bound;
  3. serve classify requests at full width (MobileNetV2 1.0, 224 px,
     bf16, hand-written depthwise kernel) through Predictor and
     ClassifyBatcher from 4 closed-loop client threads for a 10 s
     window, count the kernel's launches, and check the answers against
     the plain version on the card and the float32 forward on the CPU;
  4. print the kernel list and the card's name and power limit.
The last line is {"ok": true, "device": {...}} only when every phase
passed; any failure exits non-zero without it. Imports no JAX and
nothing of the tpunet package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time

SEED = 0
BATCH = 8
# (h, c, stride) of MobileNetV2's depthwise convs at 224 px (the shape
# list of tests/test_ops.py) and how many of the 17 layers have each.
MAIN_SHAPES = {
    (112, 32, 1): 1, (112, 96, 2): 1, (56, 144, 1): 1, (56, 144, 2): 1,
    (28, 192, 1): 2, (28, 192, 2): 1, (14, 384, 1): 4, (14, 576, 1): 2,
    (14, 576, 2): 1, (7, 960, 1): 3,
}
# (h, w, c, stride): odd H/W with stride 2, and C no multiple of 8.
ODD_SHAPES = [(15, 17, 144, 2), (28, 28, 100, 1)]
# H100 SXM data sheet: HBM rate, and the float32 rate outside the tensor
# cores (the depthwise conv is elementwise multiply-adds).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
REQUEST_SIZES = [(32, 32), (224, 224), (375, 500)]  # (h, w): CIFAR, model size, a photo
N_IMAGES = 48      # seeded images the clients cycle through, sizes in turn
N_CLIENTS = 4      # closed-loop client threads
WINDOW_S = 10.0    # serving window: thousands of requests


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of one call, by CUDA events, with L2 flushed
    before each. A spin of the card (``torch.cuda._sleep``, about 2 ms)
    is queued ahead of the start event, so the host has queued the whole
    call before the card reaches it: the interval holds device work
    only, not the host's time to launch the work."""
    for _ in range(warmup):
        fn()
    flush = torch.empty(64 * 2**20 // 4, device="cuda")  # > the 50 MB L2
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(4_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def loop_us(torch, fn, n: int = 200) -> float:
    """Per-call time of ``n`` calls made back to back (host clock, one
    synchronize at the end): the larger of the call's host cost and its
    device time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def profile_forward(torch, model, x, wall_ms: float) -> dict:
    """Device time of one batched forward by kernel family, from
    torch.profiler's CUDA activity, and the card's idle share against the
    forward's wall time (measured without the profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"device_ms": "not measured (no CUDA events in the trace)"}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    dw = [e for e in kernels if "depthwise3x3" in e.name]
    return {"device_ms": busy, "device_kernels": len(kernels),
            "depthwise_kernels": len(dw),
            "depthwise_device_ms": sum(e.time_range.elapsed_us()
                                       for e in dw) / 1e3,
            "wall_ms": wall_ms, "device_idle_share": 1.0 - busy / wall_ms}


def bf16_ulp(torch, v):
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def phase_build():
    from tpunet_torch.ops import _build
    t0 = time.perf_counter()
    names = _build.build_all()
    emit("build", kernels=names, seconds=time.perf_counter() - t0)


def phase_kernels(torch):
    """Depthwise kernel against its plain version; returns per-shape rows."""
    import torch.nn.functional as F

    from tpunet_torch.ops import depthwise as dw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(BATCH, h, h, c, s) for (h, c, s) in MAIN_SHAPES]
    cases += [(BATCH, h, w, c, s) for (h, w, c, s) in ODD_SHAPES]
    rows = []
    for i, (n, h, w, c, s) in enumerate(cases):
        g = torch.Generator().manual_seed(SEED + i)
        x32 = torch.randn(n, h, w, c, generator=g).cuda()
        w32 = torch.randn(3, 3, c, generator=g).cuda()
        k32 = dw.depthwise_conv3x3(x32, w32, s)
        p32 = dw.depthwise_conv3x3_reference(x32, w32, s)
        xb, wb = x32.bfloat16(), w32.bfloat16()
        kb = dw.depthwise_conv3x3(xb, wb, s)
        pb = dw.depthwise_conv3x3_reference(xb, wb, s)
        sum32 = dw.depthwise_conv3x3_reference(xb.float(), wb.float(), s)
        torch.cuda.synchronize()
        rel32 = ((k32 - p32).abs().max() / p32.abs().max()).item()
        check(rel32 <= 1e-5, f"depthwise f32 {(n, h, w, c, s)}: max error "
              f"{rel32:.3g} of max |y| > 1e-5")
        ulps = ((kb.float() - sum32).abs() / bf16_ulp(torch, sum32)).max().item()
        check(ulps <= 1.0, f"depthwise bf16 {(n, h, w, c, s)}: {ulps:.3g} "
              "bf16 ulps from the f32-summed result > 1")
        max_abs = max((k32 - p32).abs().max().item(),
                      (kb.float() - pb.float()).abs().max().item())
        xl = xb.permute(0, 3, 1, 2)                        # channels_last NCHW
        wl = wb.permute(2, 0, 1).unsqueeze(1).contiguous()  # [C,1,3,3]
        lib = F.conv2d(xl, wl, stride=s, padding=1, groups=c)
        lib_diff = (lib.permute(0, 2, 3, 1).float() - kb.float()).abs().max().item()
        row = {
            "shape": [n, h, w, c, s], "max_rel_err_f32": rel32,
            "max_ulp_bf16": ulps, "max_abs_err": max_abs,
            "library_max_abs_diff_bf16": lib_diff,
            "kernel_ms": time_ms(torch, lambda: dw.depthwise_conv3x3(xb, wb, s)),
            "plain_ms": time_ms(torch, lambda: dw.depthwise_conv3x3_reference(xb, wb, s)),
            "library_ms": time_ms(torch, lambda: F.conv2d(
                xl, wl, stride=s, padding=1, groups=c)),
            "kernel_loop_us": loop_us(torch, lambda: dw.depthwise_conv3x3(xb, wb, s)),
            "library_loop_us": loop_us(torch, lambda: F.conv2d(
                xl, wl, stride=s, padding=1, groups=c)),
        }
        # Least time: each input read once and the output written once,
        # or 9 multiply-adds per output element, whichever is longer.
        row["bytes_ms"] = (xb.numel() + wb.numel() + kb.numel()) * 2 \
            / HBM_BYTES_PER_S * 1e3
        row["ops_ms"] = 2 * 9 * kb.numel() / F32_FLOP_PER_S * 1e3
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        rows.append(row)
        emit("kernel_vs_plain", name="depthwise_conv3x3", **row)
    return rows


def randomize_bn(torch, model, gen) -> None:
    """Random BN affine; running statistics from one seeded batch, then
    perturbed: eval BN is not the identity, and the activations of the
    kaiming-initialized network do not collapse."""
    from tpunet_torch.models.mobilenetv2 import BN

    bns = [m for m in model.modules() if isinstance(m, BN)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
        orig = model._bn

        def from_batch(bn, y, act):
            yf = y.float()
            bn.running_mean.copy_(yf.mean(dim=(0, 2, 3)))
            bn.running_var.copy_(yf.var(dim=(0, 2, 3), unbiased=False))
            return orig(bn, y, act)

        model._bn = from_batch
        try:
            model(torch.randn(4, 3, 224, 224, generator=gen))
        finally:
            del model._bn
        for bn in bns:
            c = bn.running_mean.numel()
            bn.running_mean.add_(torch.randn(c, generator=gen) * 0.05
                                 * bn.running_var.sqrt())
            bn.running_var.mul_(torch.empty(c).uniform_(0.8, 1.25, generator=gen))


def phase_preprocess(torch, preprocess, images, data) -> None:
    """Per request size, the host time to issue the preprocessing on the
    card, its time to the result (host clock, synchronized), and the
    same transform on the host's CPU: medians of 20."""
    row = {}
    for img in images:
        preprocess(img, data, "cuda")
        torch.cuda.synchronize()
        issue, done, cpu = [], [], []
        for _ in range(20):
            t0 = time.perf_counter()
            preprocess(img, data, "cuda")
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            preprocess(img, data, "cpu")
            t3 = time.perf_counter()
            issue.append(t1 - t0)
            done.append(t2 - t0)
            cpu.append(t3 - t2)
        row[f"{img.shape[1]}x{img.shape[0]}"] = {
            "card_issue_ms": statistics.median(issue) * 1e3,
            "card_done_ms": statistics.median(done) * 1e3,
            "cpu_ms": statistics.median(cpu) * 1e3}
    emit("preprocess", **row)


def serve_window(batcher, images):
    """N_CLIENTS closed-loop clients submit the images in turn until
    WINDOW_S has passed. Returns the wall time until the last answer,
    every answer as (image index, latency s, probs), and the errors."""
    answers = [[] for _ in range(N_CLIENTS)]
    errors = []
    deadline = time.perf_counter() + WINDOW_S

    def client(k):
        i = k
        try:
            while time.perf_counter() < deadline:
                t = time.perf_counter()
                p = batcher.submit(images[i % len(images)], timeout=60.0)
                answers[k].append((i % len(images), time.perf_counter() - t, p))
                i += N_CLIENTS
        except (RuntimeError, TimeoutError) as e:
            errors.append(f"client {k}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(k,))
               for k in range(N_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WINDOW_S + 120.0)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        errors.append("clients did not finish")
    return wall, [a for per in answers for a in per], errors


def phase_main_path(torch):
    import numpy as np

    import tpunet_torch.models.mobilenetv2 as mnv2
    from tpunet_torch.config import DataConfig, ModelConfig, ServeConfig
    from tpunet_torch.infer.predict import Predictor, preprocess
    from tpunet_torch.models import create_model
    from tpunet_torch.ops import depthwise as dw
    from tpunet_torch.serve import ClassifyBatcher

    cfg = ModelConfig(use_pallas_depthwise=True)   # width 1.0, bf16 over f32
    data = DataConfig()                            # 224 px, 10 classes
    serve = ServeConfig()                          # batch 8, 2 ms window
    gen = torch.Generator().manual_seed(SEED)
    ref32 = create_model(ModelConfig(dtype="float32", use_pallas_depthwise=True),
                         device="cpu", generator=gen)
    randomize_bn(torch, ref32, gen)
    state = ref32.state_dict()
    pred = Predictor(cfg, data, state_dict=state, device="cuda")
    cpu = Predictor(ModelConfig(dtype="float32", use_pallas_depthwise=True),
                    data, state_dict=state, device="cpu")

    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (*REQUEST_SIZES[i % 3], 3), np.uint8)
              for i in range(N_IMAGES)]
    phase_preprocess(torch, preprocess, images[:3], data)

    def batcher():
        return ClassifyBatcher(pred, batch_max=serve.classify_batch_max,
                               window_ms=serve.classify_window_ms)

    warm = batcher()                               # warm-up, not counted
    try:
        for img in images[:3]:
            warm.submit(img, timeout=120.0)
    finally:
        warm.close()
    torch.cuda.synchronize()
    served = batcher()
    dw.depthwise_conv3x3.launches = 0
    try:
        wall, answers, errors = serve_window(served, images)
    finally:
        served.close()          # joins the worker: its counters are final
    launches = dw.depthwise_conv3x3.launches
    snap = served.registry.snapshot()
    check(not errors, f"requests failed: {errors[:3]}")
    n = len(answers)
    batches = snap.get("serve_classify_batches_total", 0)
    check(n >= 16 and snap.get("serve_classify_requests_total") == n,
          f"{n} answers, {snap.get('serve_classify_requests_total')} "
          "requests counted")
    probs = np.stack([p for _, _, p in answers])
    check(probs.shape == (n, cfg.num_classes), f"probs {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite probabilities")
    sums = probs.sum(axis=1)
    check(bool(np.all(np.abs(sums - 1.0) <= 1e-4)),
          f"probabilities sum to {sums.min()}..{sums.max()}")
    check(launches > 0 and launches == 17 * batches,
          f"{launches} depthwise launches for {batches} batched forwards "
          "(want 17 each)")
    lat_ms = np.array([s for _, s, _ in answers]) * 1e3
    by_size = {f"{REQUEST_SIZES[k][1]}x{REQUEST_SIZES[k][0]}":
               float(np.percentile([s for i, s, _ in answers if i % 3 == k],
                                   50)) * 1e3 for k in range(3)}
    emit("main_path", requests=n, clients=N_CLIENTS, window_s=WINDOW_S,
         wall_s=wall, batches=batches, mean_batch=n / batches,
         depthwise_launches=launches, requests_per_s=n / wall,
         latency_p50_ms=float(np.percentile(lat_ms, 50)),
         latency_p99_ms=float(np.percentile(lat_ms, 99)),
         latency_max_ms=float(lat_ms.max()),
         latency_p50_ms_by_size=by_size,
         batch_s_p50_ms=snap["serve_classify_s_p50"] * 1e3,
         batch_s_p99_ms=snap["serve_classify_s_p99"] * 1e3)

    # The same batch through the kernel and through the plain version on
    # the card: the plain version repeats the kernel's arithmetic, so the
    # logits should agree to the bit; the stated tolerance is 2 bf16 ulps
    # of the largest logit.
    x = torch.stack([preprocess(images[i], data, "cuda")
                     for i in range(BATCH)]).permute(0, 3, 1, 2)
    lib = create_model(ModelConfig(), device="cuda")   # cuDNN depthwise
    lib.load_state_dict(state)
    with torch.inference_mode():
        kern = pred.model(x)
        mnv2.depthwise_conv3x3 = dw.depthwise_conv3x3_reference
        try:
            plain = pred.model(x)
        finally:
            mnv2.depthwise_conv3x3 = dw.depthwise_conv3x3
        cudnn = lib(x)
        torch.cuda.synchronize()
    diff = (kern - plain).abs().max().item()
    tol = 2 * 2.0**-7 * plain.abs().max().item()
    check(diff <= tol, f"batched logits kernel vs plain version: {diff} > {tol}")
    check(bool(torch.isfinite(kern).all()), "non-finite logits")

    # Top-1 against the float32 forward on the CPU, on the image whose
    # CPU top-1 leads its top-2 by the widest margin.
    with torch.inference_mode():
        ref = cpu.model(x.cpu().float())
    top2 = ref.topk(2, dim=1).values
    i = int((top2[:, 0] - top2[:, 1]).argmax())
    agree = int((ref.argmax(1) == kern.cpu().argmax(1)).sum())
    check(int(ref[i].argmax()) == int(kern[i].argmax()),
          f"image {i}: card top-1 {int(kern[i].argmax())}, CPU f32 top-1 "
          f"{int(ref[i].argmax())}")
    emit("main_path_checks", logits_kernel_vs_plain_max_abs=diff,
         tolerance=tol, logits_kernel_vs_cudnn_depthwise_max_abs=(
             kern - cudnn).abs().max().item(),
         logits_card_bf16_vs_cpu_f32_max_abs=(kern.cpu() - ref).abs().max().item(),
         top1_agree_with_cpu_f32=f"{agree}/{BATCH}", checked_image=i)

    # One batched forward, kernel against cuDNN's depthwise (F.conv2d,
    # use_pallas_depthwise=False), in turns: wall time per forward run
    # back to back, then the device time of each by profiler.
    with torch.inference_mode():
        wall = [loop_us(torch, lambda: pred.model(x), n=20) / 1e3,
                loop_us(torch, lambda: lib(x), n=20) / 1e3,
                loop_us(torch, lambda: lib(x), n=20) / 1e3,
                loop_us(torch, lambda: pred.model(x), n=20) / 1e3]
    emit("forward", batch=BATCH, wall_ms_kernel=[wall[0], wall[3]],
         wall_ms_cudnn_depthwise=[wall[1], wall[2]],
         profile_kernel=profile_forward(torch, pred.model, x,
                                        (wall[0] + wall[3]) / 2),
         profile_cudnn_depthwise=profile_forward(torch, lib, x,
                                                 (wall[1] + wall[2]) / 2))
    return launches


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        phase_build()
        rows = phase_kernels(torch)
        launches = phase_main_path(torch)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    def per_forward(key):
        by_shape = {(r["shape"][1], r["shape"][3], r["shape"][4]): r[key]
                    for r in rows}
        return sum(by_shape[s] * k for s, k in MAIN_SHAPES.items())

    bytes_ms, ops_ms = per_forward("bytes_ms"), per_forward("ops_ms")
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": [{
        "name": "depthwise_conv3x3",
        "route": "cuda",
        "source": "tpunet_torch/csrc/depthwise.cu",
        "replaces": "tpunet/ops/depthwise.py:74",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_forward("kernel_ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": per_forward("library_ms"),
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
