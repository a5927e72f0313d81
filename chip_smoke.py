"""Drive the PyTorch port (tpunet_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repo root; needs a CUDA card and nvcc

Phases, each of which must pass:
  1. build every kernel under tpunet_torch/csrc with nvcc, print ptxas's
     registers and spills per kernel and the SASS mix of the tensor-core
     kernels, and fail if the depthwise forward is missing or spills, a
     tensor-core flash kernel spills at head dim 64, or a bf16 fused-IR
     kernel is missing, spills, or (the tensor-core ones) has no HMMA;
  2. hold the depthwise forward kernel to its plain PyTorch version, bit
     for bit, at MobileNetV2's 10 depthwise shapes (batch 8, f32 and
     bf16) plus odd cases and at the 10 shapes at batch 128 in bf16, and
     time kernel, plain version, the library call and the bound at batch
     8 (serving) and 128 (training), with the share of the memory rate
     and the plan;
  3. the same for the training kernels — the depthwise backward and the
     fused-IR forward and backward — at every MobileNetV2 shape (batch 8,
     f32 and bf16) plus odd cases, then checked again (the depthwise
     backward in f32 and bf16) and timed at batch 128 in bf16, the
     training main path's inputs, where two launches of the depthwise
     backward, and of the fused-IR forward and backward, must also give
     the same outputs bit for bit;
  4. serve classify requests at full width (MobileNetV2 1.0, 224 px,
     bf16, hand-written depthwise kernel) through Predictor and
     ClassifyBatcher from 4 closed-loop client threads for a 5 s
     window, count the kernel's launches, and check the answers against
     the plain version on the card and the float32 forward on the CPU;
  5. train at full width (width 1.0, 224 px, batch 128, bf16 over f32,
     fused_ir and the hand-written depthwise kernels, seeded synthetic
     CIFAR-10) through the port's train step: one step's loss, gradients
     and BN running statistics against the same step with the plain
     versions on the card; then, with every launch count set to 0, 30
     steps on one repeated batch, whose loss must stay finite and fall,
     counting 17 + 17 + 33 + 33 launches a step; step time, images/s
     and the card's idle share over one step (torch.profiler); then one
     step at batch 512, whose 112 px fused-IR layers have 100,352 row
     tiles (past grid y's 65,535): a finite loss, the same launches,
     its peak memory within the card's;
  6. run the Trainer for one epoch (1,024 synthetic images, batch 128)
     with eval, reload the best .pth and evaluate it again, then
     ``python -m tpunet_torch.train --eval-only`` on it; its obs_epoch
     record: 8 steps and 8 step-time samples, finite percentiles, only
     fields docs/metrics_schema.md documents, MFU in (0, 1) equal to
     examples/s x train_flops_per_unit / 989e12, the card's memory
     (0 < in use <= peak <= limit) and the mem_peak_bytes_in_use gauge;
     the same epoch with --no-obs and, through the CLI in this process,
     with a profile window over steps [2, 4), --statsd and --obs-http to
     listeners here and --obs-rule 'mfu > 0': as many
     torch.cuda.synchronize calls from tpunet_torch with obs on as with
     --no-obs, 2 more with the window; one trace with exactly 2 train
     step regions and the depthwise and fused-IR kernels; the statsd
     mfu line, the obs_epoch line over HTTP and the rule's obs_alert
     after the obs_epoch record; tpunet_torch.obs.summary over the
     records; its laps beside phase 5's synchronised step;
  7. dp_step: data parallelism with 2 ranks sharing the card (gloo; NCCL
     refuses two ranks on one device), each a subprocess of this script
     (``--dp-worker step``) on 64 rows of phase 5's seeded batch of 128
     at full width: one f32 step's all-reduced gradients and BN running
     statistics against phase 5's world-1 kernel step on the 128 (each
     error at most twice the cuDNN/F.conv2d path's distance from it),
     the first bf16 step's global loss within 2^-7 of the world-1 one,
     the ranks' parameters equal to the bit after 3 updates, and
     17 + 17 + 33 + 33 launches a rank-step;
  8. dp_trainer: ``python -m tpunet_torch.train --preset distributed``
     at world 1 over NCCL for phase 6's epoch, its epoch record against
     phase 6's (losses within 1e-3 relative, accuracies within 0.01;
     whether it is equal to the bit is printed), ``--eval-only`` of its
     best.pth, and 30 steps at batch 128 timed over NCCL (``--dp-worker
     time``) against phase 5's step, with 105 all-reduces a step (52 BN
     forward, 52 BN backward, 1 gradient buffer) and their device share;
  9. hold the three flash-attention kernels (forward with lse, dQ, dK/dV)
     against their plain versions in f32 and bf16 at ViT-B/16's shapes
     (batch 8 and 128, T 196, 12 heads of 64) and at odd ones (causal
     T 1024, causal tq < tk, packed segments with a query that sees no
     key, T that no tile divides, head dims 16, 32 and 128, a nonzero
     glse, T of 1, 15, 17, 65, Tk 9 < Tq 40, causal Tq 5 < Tk 70); in
     bf16 also the forward output, dQ, dK and dV against the plain
     versions on float32 copies of the inputs, within twice the plain
     bf16 versions' error; and time them at batch 128 against their bound,
     their plain versions and scaled_dot_product_attention (forward; its
     backward through autograd for dQ and dK/dV together);
 10. serve ViT-B/16 (224 px, bf16, random weights from a seed) through
     Predictor and ClassifyBatcher with the same clients and images as
     phase 4, 12 flash launches a batched forward, logits against the
     plain versions on the card;
 11. train ViT-B/16 (batch 128, bf16 over f32, Adam 1e-4, seeded
     synthetic CIFAR-10): one f32 step's loss and gradients with the
     kernels against the plain versions; 30 steps with 12 + 12 + 12
     flash launches each, step time, images/s, peak memory and a
     profiled step; a Trainer epoch with --model vit_base and
     --eval-only on its best.pth, with phase 6's obs checks (no
     exporters; the window's trace shows the three flash kernels);
 12. the LM (``--model lm`` at ViT-B/16's widths: hidden 768, depth 12,
     12 heads of 64, vocab 256, T 1024, batch 16, bf16 over f32, random
     weights from a seed): ``lm_kernels`` holds the three flash kernels
     to their plain versions in f32 and bf16 (bf16 also against the
     float32 truth) at B 16, T 1024, causal, and on the first 16 packed
     rows of a corpus concatenated from the repo's Markdown (causal +
     segments), and times them there against their bound, their plain
     versions and SDPA (``is_causal=True``; a boolean mask for the packed
     rows); ``lm_train``: one f32 step with the kernels against the plain
     versions (loss within 1e-5, every gradient within 1e-4 of the
     largest), 30 bf16 steps on synthetic_lm (12 + 12 + 12 flash
     launches a step, a falling loss, step time, tokens/s, peak memory,
     a profiled step), 5 packed steps (the same launches, a falling
     loss); ``lm_trainer``: the CLI for one synthetic_lm epoch (in
     this process, with phase 6's obs checks, no exporters) and
     ``--eval-only``, one packed text_lm epoch, and the generate CLI on
     it; ``lm_generate``: greedy KV-cache decoding at B 8 (128-token
     prompts, 256 new) with no flash launch, its logits teacher-forced
     against the no-cache forward's (12 flash launches), and in f32 the
     cache and no-cache tokens equal;
 13. serve_engine: the LM serving engine (``tpunet_torch.serve``) at
     phase 12's widths in bf16 behind its HTTP server with the
     ServeConfig defaults (8 slots, prefill buckets 32/128/512, paged KV
     of 16-token pages, the prefix cache, device sampling): 8
     closed-loop clients send 48 /v1/generate requests (prompts of
     24-480 seeded tokens, half behind one shared 256-token prefix, 128
     new tokens each, half greedy, half sampled at temperature 0.8,
     top-k 40, top-p 0.95, a quarter streamed) while 2 clients cycle
     phase 4's images through /v1/classify (MobileNetV2 1.0, the hand
     depthwise): every request 200 with 128 tokens, 17 depthwise
     launches a classify forward, no flash launch, the classify
     probabilities within 2^-7 of the largest logit of
     Predictor.predict_probs'; tokens/s, requests/s, TTFT and per-token
     percentiles, prefill against prompt tokens, classify rate and
     latency; one sampled request alone and co-batched with 7 others,
     the same tokens; a profiled decode iteration of 8 slots (its host
     bookkeeping around the step); in float32 the engine's greedy tokens
     equal to generate's in the dense, paged, prefix-hit and preempting
     pools; and ``python -m tpunet_torch.serve`` as a subprocess, which
     answers, finishes an in-flight stream through SIGTERM while new
     requests get 503 with Retry-After, exits 0 and leaves obs_serve
     records;
 14. serve_item5: the rest of the serving engine at phase 12's widths.
     int8 KV pages: quantize_kv_rows on the card equal to the CPU's
     (codes, bit-equal scales) on 4,096 seeded bf16 rows of [12, 64]
     with an all-zero and an outlier row; the int8 paged attend (8
     slots, T 1 and 5) within 1e-5 of the float32 attend on the card
     over K/V gathered and dequantised on the host from the same pool; kv_bytes_per_token
     below 0.6 of bf16's; readings: the share of greedy tokens int8 and
     bf16 pools give alike, and the pages each holds in the same memory.
     Speculative decoding at K 4, in float32: greedy tokens equal to
     generate's on the float32 parity prompts with self-speculation and
     a seeded half-width drafter, a sampled stream equal to spec-off's,
     accepted + rejected = drafted, no page leaked; readings: the
     acceptance rates, drafter_pool_bytes, and in bf16 the traffic of
     phase 13 (8 clients, 48 requests) with self-speculation, and its
     first 24 requests with a half-width drafter fitted by fit_drafter to
     the traffic's prompts (300 steps, timed), beside phase 13's spec-off
     pass. The prefix
     store: two engines in turn on one store directory, the bf16 pool
     then the int8 pool: the second warm-loads the first's pages,
     prefills only the prompt past their page-aligned prefix, and gives
     the first engine's tokens. Chaos: ``python -m tpunet_torch.serve
     --chaos kill@tokens=5`` as a subprocess streams exactly 5 tokens
     and dies by SIGKILL. No kernel launches on this path;
 15. print the kernel list and the card's name and power limit.
The last line is {"ok": true, "device": {...}} only when every phase
passed; any failure exits non-zero without it. Imports no JAX and
nothing of the tpunet package.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
BATCH = 8            # kernel checks and the serving batch
TRAIN_BATCH = 128    # the training batch (preset "single"): kernel timing
# (h, c, stride) of MobileNetV2's depthwise convs at 224 px (the shape
# list of tests/test_ops.py) and how many of the 17 layers have each.
MAIN_SHAPES = {
    (112, 32, 1): 1, (112, 96, 2): 1, (56, 144, 1): 1, (56, 144, 2): 1,
    (28, 192, 1): 2, (28, 192, 2): 1, (14, 384, 1): 4, (14, 576, 1): 2,
    (14, 576, 2): 1, (7, 960, 1): 3,
}
# (h, w, c, stride): odd H/W with stride 2, and C no multiple of 8.
ODD_SHAPES = [(15, 17, 144, 2), (28, 28, 100, 1)]
# (h, ci, co) of MobileNetV2's 33 fused-IR 1x1 convs at 224 px and how
# many layers have each: 16 expands (ReLU6) and 17 projects (linear).
EXPAND_SHAPES = {(112, 16, 96): 1, (56, 24, 144): 2, (28, 32, 192): 3,
                 (14, 64, 384): 4, (14, 96, 576): 3, (7, 160, 960): 3}
PROJECT_SHAPES = {(112, 32, 16): 1, (56, 96, 24): 1, (56, 144, 24): 1,
                  (28, 144, 32): 1, (28, 192, 32): 2, (14, 192, 64): 1,
                  (14, 384, 64): 3, (14, 384, 96): 1, (14, 576, 96): 2,
                  (7, 576, 160): 1, (7, 960, 160): 2, (7, 960, 320): 1}
# (m, ci, co): Ci or Co no multiple of 8, M no multiple of the 64-row tile.
ODD_FUSED = [(1000, 13, 24), (777, 96, 10)]
# H100 SXM data sheet: HBM rate, the float32 rate outside the tensor
# cores (the depthwise conv is elementwise multiply-adds), and the dense
# bf16 tensor-core rate (the fused-IR products).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TRAIN_STEPS = 30     # steps of the training main path, one repeated batch
REQUEST_SIZES = [(32, 32), (224, 224), (375, 500)]  # (h, w): CIFAR, model size, a photo
N_IMAGES = 48      # seeded images the clients cycle through, sizes in turn
N_CLIENTS = 4      # closed-loop client threads
WINDOW_S = 5.0     # serving window: over a thousand requests
VIT_LAYERS = 12    # ViT-B/16: one flash call per layer and direction
# (b, tq, tk, h, d, causal, segments, glse) of the flash kernel checks:
# the serving and training shapes of ViT-B/16 first, then odd cases.
FLASH_CASES = [
    (BATCH, 196, 196, 12, 64, False, False, False),
    (TRAIN_BATCH, 196, 196, 12, 64, False, False, False),
    (2, 1024, 1024, 12, 64, True, False, False),    # the LM's max_seq_len
    (4, 100, 300, 4, 64, True, False, False),       # tq < tk: tk - tq offset
    (4, 256, 256, 4, 64, False, True, False),       # a query with no key
    (4, 200, 200, 4, 64, True, True, False),
    (4, 77, 77, 4, 32, False, False, False),        # no tile divides T
    (2, 150, 150, 2, 128, True, False, False),
    (BATCH, 196, 196, 12, 64, False, False, True),  # nonzero glse
    # T that cut through the tensor-core kernels' 16-row warps and their
    # 8-key / 16-key steps.
    (2, 1, 1, 4, 64, False, False, False),
    (2, 15, 15, 4, 64, False, False, False),
    (2, 17, 17, 4, 64, True, False, False),
    (2, 65, 65, 4, 64, False, False, True),
    (2, 40, 9, 4, 64, False, False, False),         # Tk below one n8 step
    (2, 5, 70, 4, 64, True, False, False),          # the diagonal in a warp
    (2, 196, 196, 4, 16, False, False, False),
    (2, 196, 196, 4, 128, False, False, False),
    (2, 33, 33, 4, 32, False, True, False),
]
# How each flash kernel computes, in bf16 (the main path's type).
FLASH_DESIGN = {
    "flash_attention_forward": "mma.sync m16n8k16 bf16, ldmatrix, "
                               "cp.async x2, P in registers",
    "flash_attention_dq": "mma.sync m16n8k16 bf16, ldmatrix, "
                          "cp.async x2, dS in registers, no atomics",
    "flash_attention_dkv": "mma.sync m16n8k16 bf16, ldmatrix, "
                           "cp.async x2, P and dS in registers",
}
# The bf16 fused-IR kernels (csrc/fused_ir.cu): the tensor-core ones, and
# the kernel that writes t for the wide ones.
FUSED_TC_KERNELS = ("fused_ir_fwd_mma", "fused_ir_bwd_one_pass",
                    "fused_ir_bwd_dx_mma<true>", "fused_ir_bwd_dx_mma<false>",
                    "fused_ir_bwd_dw_mma<true>", "fused_ir_bwd_dw_mma<false>")
FUSED_BF16_KERNELS = FUSED_TC_KERNELS + ("fused_ir_bwd_t<true>",
                                         "fused_ir_bwd_t<false>")

# The profile window of the window epochs: steps [2, 4) of the epoch.
OBS_WINDOW = ("--profile-start-step", "2", "--profile-num-steps", "2")
# The hand kernels a window's trace must show, by kernel_label.
MNV2_WINDOW_KERNELS = ("depthwise3x3_fwd", "depthwise3x3_bwd", "fused_ir_")
FLASH_WINDOW_KERNELS = ("flash_fwd_mma", "flash_bwd_dq_mma",
                        "flash_bwd_dkv_mma")

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
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels, _ = device_activity(prof)
    if not kernels:
        return {"device_ms": "not measured (no CUDA events in the trace)"}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    dw = [e for e in kernels if "depthwise3x3" in e.name]
    return {"device_ms": busy, "device_kernels": len(kernels),
            "depthwise_kernels": len(dw),
            "depthwise_device_ms": sum(e.time_range.elapsed_us()
                                       for e in dw) / 1e3,
            "wall_ms": wall_ms, "device_idle_share": 1.0 - busy / wall_ms}


def device_activity(prof) -> tuple:
    """The card's own activity in a torch.profiler trace: its kernels,
    copies and fills, as (events, {name: ms} of what was left out). A GPU
    user annotation (the ``Optimizer.step`` range, which spans kernels
    that are counted already) is a CUDA-side event too; torch marks it
    ``is_user_annotation`` (torch 2.11 exposes no activity kind), and it
    is left out, as torch's own device-time totals leave it out."""
    from torch.autograd import DeviceType

    kept, excluded = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.is_user_annotation:
            excluded[e.name] = (excluded.get(e.name, 0.0)
                                + e.time_range.elapsed_us() / 1e3)
        else:
            kept.append(e)
    return kept, excluded


def bf16_ulp(torch, v):
    """Spacing of bfloat16 numbers at |v| (8 significant bits)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.exp2(e - 7)


def kernel_label(mangled: str) -> str:
    """``flash_fwd_mma<64>`` for the mangled name of a kernel in the
    anonymous namespace of a csrc source, or the mangled name itself."""
    m = re.match(r"_ZN(\d+)", mangled)        # the namespace's length
    m = m and re.compile(r"\d+").match(mangled, m.end() + int(m.group(1)))
    if not m:
        return mangled
    end = m.end() + int(m.group())
    name, rest = mangled[m.end():end], mangled[end:]
    args = []
    if rest.startswith("If"):
        args.append("float")
    elif rest.startswith("I13__nv_bfloat16"):
        args.append("bf16")
    args += re.findall(r"Li(\d+)E", rest)
    args += ["true" if b == "1" else "false"
             for b in re.findall(r"Lb([01])E", rest)]
    return f"{name}<{', '.join(args)}>" if args else name


def sass_mix(path, labels) -> dict:
    """Static instruction mix of the kernels ``labels`` in a built library,
    from cuobjdump: all instructions, and the tensor-core products (HMMA),
    shared-memory matrix loads (LDSM), special-function ops (MUFU, the
    exps) and async copies (LDGSTS) among them."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=300).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"not measured": str(e)}
    mix = {}
    for sec in re.split(r"\n\s*Function : ", sass)[1:]:
        label = kernel_label(sec.split("\n", 1)[0].strip())
        if label in labels:
            ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                             sec)
            mix[label] = {"instructions": len(ops), **{
                op: ops.count(op) for op in ("HMMA", "LDSM", "MUFU",
                                             "LDGSTS")}}
    return mix


def phase_build():
    """Build every kernel source; emit ptxas's registers and spills per
    kernel and the instruction mix of the three tensor-core flash kernels
    at D = 64 and of the tensor-core fused-IR kernels; fail if the
    depthwise forward is missing or spills, if one of those flash kernels
    spills, or a bf16 fused-IR kernel is missing or spills, or a
    tensor-core fused-IR kernel has no HMMA (the main paths)."""
    from tpunet_torch.ops import _build
    t0 = time.perf_counter()
    names = _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {f"{name}:{kernel_label(k)}": v for name in names
             for k, v in _build.resources(name).items()}
    sass = sass_mix(_build.library_path("flash"),
                    ("flash_fwd_mma<64>", "flash_bwd_dq_mma<64>",
                     "flash_bwd_dkv_mma<64>"))
    sass.update(sass_mix(_build.library_path("fused_ir"), FUSED_TC_KERNELS))
    dw_fwd = {k: v for k, v in ptxas.items()
              if k.startswith("depthwise:depthwise3x3_fwd<")}
    emit("build", kernels=names, seconds=seconds, ptxas=ptxas, sass=sass,
         depthwise_fwd_registers={k: v.get("registers")
                                  for k, v in dw_fwd.items()})
    check(len(dw_fwd) == 4, f"ptxas reported {sorted(dw_fwd)}, want the "
          "depthwise forward in f32 and bf16, vector and scalar paths")
    spills = [k for k, v in dw_fwd.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)]
    check(not spills, f"depthwise forward kernels {spills} spill registers")
    mma = {k: v for k, v in ptxas.items()
           if k.startswith("flash:") and "_mma<" in k}
    check(len(mma) == 12, f"ptxas reported {sorted(mma)}, want the 3 "
          "tensor-core flash kernels at 4 head dims")
    spills = [k for k, v in mma.items()
              if k.endswith("<64>") and v.get("spill_stores", 1)]
    check(not spills, f"{spills} spill registers at D = 64")
    fused = {k: ptxas.get(f"fused_ir:{k}") for k in FUSED_BF16_KERNELS}
    check(all(fused.values()), f"ptxas reported no "
          f"{[k for k, v in fused.items() if not v]} in csrc/fused_ir.cu")
    spills = [k for k, v in fused.items()
              if v.get("spill_stores", 1) or v.get("spill_loads", 1)]
    check(not spills, f"fused-IR kernels {spills} spill registers")
    no_hmma = [k for k in FUSED_TC_KERNELS
               if not sass.get(k, {}).get("HMMA")]
    check(not no_hmma, f"fused-IR kernels {no_hmma} show no HMMA in their "
          f"SASS ({sass.get('not measured', 'cuobjdump ran')})")


def dw_fwd_bound(x, w, y) -> dict:
    """Least time of the depthwise forward: each input read once and the
    output written once, or 9 multiply-adds per output element at the
    float32 rate, whichever is longer."""
    bytes_ms = (x.numel() + w.numel() + y.numel()) * x.element_size() \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 9 * y.numel() / F32_FLOP_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms)}


def phase_kernels(torch):
    """Depthwise forward kernel against its plain version, to the bit, at
    every shape in f32 and bf16 (batch 8) and in bf16 at batch 128 (the
    training main path's inputs); returns per-shape rows with the times,
    the share of the memory rate and the plan."""
    import torch.nn.functional as F

    from tpunet_torch.ops import depthwise as dw

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [(BATCH, h, h, c, s) for (h, c, s) in MAIN_SHAPES]
    cases += [(BATCH, h, w, c, s) for (h, w, c, s) in ODD_SHAPES]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        # The kernel repeats the plain version's arithmetic: the same bits.
        check(bool(torch.equal(k32, p32)), f"depthwise f32 {(n, h, w, c, s)}: "
              "differs from the plain version")
        check(bool(torch.equal(kb, pb)), f"depthwise bf16 {(n, h, w, c, s)}: "
              "differs from the plain version")
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
        row.update(dw_fwd_bound(xb, wb, kb))
        row.update(hbm_share=row["bytes_ms"] / row["kernel_ms"],
                   plan=dw.forward_plan(n, h, w, c, s, 2, sms)._asdict())
        if (h, c, s) in MAIN_SHAPES:
            # The same layer at the training batch, bf16: held to the plain
            # version to the bit, then timed.
            xt = torch.randn(TRAIN_BATCH, h, w, c, generator=g).cuda().bfloat16()
            xtl = xt.permute(0, 3, 1, 2)
            yt = dw.depthwise_conv3x3(xt, wb, s)
            pt = dw.depthwise_conv3x3_reference(xt, wb, s)
            torch.cuda.synchronize()
            check(bool(torch.equal(yt, pt)), f"depthwise bf16 "
                  f"{(TRAIN_BATCH, h, w, c, s)}: differs from the plain version")
            del pt
            b128 = dw_fwd_bound(xt, wb, yt)
            row["b128"] = {
                "kernel_ms": time_ms(torch, lambda: dw.depthwise_conv3x3(xt, wb, s)),
                "plain_ms": time_ms(torch, lambda: dw.depthwise_conv3x3_reference(
                    xt, wb, s), reps=10),
                "library_ms": time_ms(torch, lambda: F.conv2d(
                    xtl, wl, stride=s, padding=1, groups=c)),
                "bound_ms": b128["bound_ms"], "bytes_ms": b128["bytes_ms"],
                "ops_ms": b128["ops_ms"],
                "plan": dw.forward_plan(TRAIN_BATCH, h, w, c, s, 2,
                                        sms)._asdict()}
            row["b128"]["hbm_share"] = (row["b128"]["bytes_ms"]
                                        / row["b128"]["kernel_ms"])
        rows.append(row)
        emit("kernel_vs_plain", name="depthwise_conv3x3", **row)
    return rows


def fused_shapes():
    """[(h, ci, co, act, layers)] of the 33 fused-IR convs at 224 px."""
    return ([(h, ci, co, True, k) for (h, ci, co), k in EXPAND_SHAPES.items()]
            + [(h, ci, co, False, k)
               for (h, ci, co), k in PROJECT_SHAPES.items()])


def rand_chan(torch, co, gen):
    """A [6, Co] float32 ``chan`` (inv, shift, r, mr, r1/n, r2/n) whose
    ReLU6 mask cuts through the data: shifts of a few units."""
    return torch.stack([torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen) * 3,
                        torch.rand(co, generator=gen) + 0.5,
                        torch.randn(co, generator=gen),
                        torch.randn(co, generator=gen) * 0.1,
                        torch.randn(co, generator=gen) * 0.1]).cuda()


def within(torch, got, want, tol) -> tuple:
    """(all |got - want| <= tol, max |got - want|, max of that over tol)."""
    d = (got.float() - want.float()).abs()
    return (bool((d <= tol).all()), d.max().item(),
            (d / tol.clamp_min(1e-30)).max().item())


def check_dw_bwd(torch, dw, x, wt, g, s, dtypes) -> float:
    """Depthwise backward kernel against its plain version in each of
    ``dtypes``. dx repeats the plain version's tap order: equal to the
    bit. dw sums the same float32 products in another order: within 1e-5
    of the sum of their magnitudes (an f32 sum of k terms in any order is
    within ~k*2^-24 of it, k <= 1.6e6 here, and both orders are
    pairwise-ish), plus one bf16 ulp when rounded to bf16. Returns the
    max abs error."""
    worst = 0.0
    for dt in dtypes:
        xd, wd, gd = x.to(dt), wt.to(dt), g.to(dt)
        dx, dwt = dw.depthwise_conv3x3_backward(xd, wd, gd, s)
        pdx, pdw = dw.depthwise_conv3x3_backward_reference(xd, wd, gd, s)
        _, mag = dw.depthwise_conv3x3_backward_reference(xd.abs(), wd,
                                                         gd.abs(), s)
        torch.cuda.synchronize()
        tag = f"depthwise backward {dt} {(*x.shape, s)}"
        check(bool(torch.equal(dx, pdx)), f"{tag}: dx differs from the "
              f"plain version by {(dx.float() - pdx.float()).abs().max().item()}")
        tol = 1e-5 * mag + (bf16_ulp(torch, pdw) if dt == torch.bfloat16 else 0)
        ok, err, ratio = within(torch, dwt, pdw, tol)
        check(ok, f"{tag}: dw error {err} is {ratio:.3g}x its tolerance")
        worst = max(worst, err)
    return worst


def check_fused(torch, fi, x, wt, y0, g, chan, act, dtypes) -> tuple:
    """Fused-IR forward and backward kernels against their plain versions
    in each of ``dtypes``. Every output is a float32 sum of products taken
    in another order: within 1e-5 of the sum of the products' magnitudes,
    plus one bf16 ulp for what is rounded to bf16 (y, dx). The column
    sums of the rounded y: within 1e-5 of sum |y| (sum y^2). Returns the
    max abs errors of (forward, backward)."""
    worst_f = worst_b = 0.0
    for dt in dtypes:
        xd, wd, yd, gd = x.to(dt), wt.to(dt), y0.to(dt), g.to(dt)
        tag = (f"fused_ir {dt} m={x.shape[0]} ci={x.shape[1]} "
               f"co={wt.shape[1]} act={act}")
        y, sums = fi.fused_ir_forward(xd, wd)
        py, _ = fi.fused_ir_forward_reference(xd, wd)
        ulp = bf16_ulp(torch, py.float()) if dt == torch.bfloat16 else 0
        ok, err, ratio = within(torch, y, py,
                                1e-5 * (xd.float().abs() @ wd.float().abs()) + ulp)
        check(ok, f"{tag}: forward y error {err} is {ratio:.3g}x its tolerance")
        yb = y.float()
        want = torch.stack([yb.sum(0), (yb * yb).sum(0)])
        smag = torch.stack([yb.abs().sum(0), (yb * yb).sum(0)])
        del y, py, yb
        ok, err_s, ratio = within(torch, sums, want, 1e-5 * smag + 1e-30)
        check(ok, f"{tag}: forward sums error {err_s} is {ratio:.3g}x its tolerance")
        worst_f = max(worst_f, err, err_s)
        dx, dwt = fi.fused_ir_backward(xd, gd, yd, wd, chan, act)
        pdx, pdw = fi.fused_ir_backward_reference(xd, gd, yd, wd, chan, act)
        t = fi.grad_conv_out(gd, yd, chan, act).abs()
        ulp = bf16_ulp(torch, pdx.float()) if dt == torch.bfloat16 else 0
        ok, err, ratio = within(torch, dx, pdx,
                                1e-5 * (t @ wd.float().abs().t()) + ulp)
        check(ok, f"{tag}: backward dx error {err} is {ratio:.3g}x its tolerance")
        ok, err_w, ratio = within(torch, dwt, pdw,
                                  1e-5 * (xd.float().abs().t() @ t) + 1e-30)
        check(ok, f"{tag}: backward dw error {err_w} is {ratio:.3g}x its tolerance")
        worst_b = max(worst_b, err, err_w)
    torch.cuda.synchronize()
    return worst_f, worst_b


def phase_train_kernels(torch):
    """The training kernels against their plain versions at every shape
    (batch 8, f32 and bf16, plus odd cases; then batch 128 in bf16, the
    main path's inputs and splits), and their times at batch 128 in bf16
    with L2 flushed. Returns {kernel name: per-shape rows}."""
    from tpunet_torch.ops import depthwise as dw
    from tpunet_torch.ops import fused_ir as fi

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    f32, bf = torch.float32, torch.bfloat16
    rows = {"depthwise_conv3x3_backward": [], "fused_ir_forward": [],
            "fused_ir_backward": []}
    gen = torch.Generator().manual_seed(SEED + 100)

    def dw_inputs(n, h, w, c, s):
        ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
        return (torch.randn(n, h, w, c, generator=gen).cuda(),
                torch.randn(3, 3, c, generator=gen).cuda(),
                torch.randn(n, ho, wo, c, generator=gen).cuda())

    cases = [(h, h, c, s, k) for (h, c, s), k in MAIN_SHAPES.items()]
    cases += [(h, w, c, s, 0) for (h, w, c, s) in ODD_SHAPES]
    for h, w, c, s, layers in cases:
        err = check_dw_bwd(torch, dw, *dw_inputs(BATCH, h, w, c, s), s,
                           (f32, bf))
        row = {"shape": [BATCH, h, w, c, s], "layers": layers,
               "max_abs_err": err}
        if layers:
            x, wt, g = dw_inputs(TRAIN_BATCH, h, w, c, s)
            row["max_abs_err_b128"] = check_dw_bwd(torch, dw, x, wt, g, s,
                                                   (f32, bf))
            x, wt, g = x.to(bf), wt.to(bf), g.to(bf)
            # No atomics: a second launch on the same inputs gives the
            # same bits.
            first = dw.depthwise_conv3x3_backward(x, wt, g, s)
            again = dw.depthwise_conv3x3_backward(x, wt, g, s)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"depthwise backward {(TRAIN_BATCH, h, w, c, s)}: two "
                  "launches on the same inputs differ")
            del first, again
            xl, gl = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
            wl = wt.permute(2, 0, 1).unsqueeze(1).contiguous()
            # x, g, w read once; dx and dw written once. dx: 9 taps per
            # gradient element; dw: 9 products per gradient element.
            nbytes = (x.numel() * 2 + g.numel() + wt.numel() * 2) * 2
            row.update(b128_times(
                torch, nbytes, 36 * g.numel() / F32_FLOP_PER_S * 1e3,
                lambda: dw.depthwise_conv3x3_backward(x, wt, g, s),
                lambda: dw.depthwise_conv3x3_backward_reference(x, wt, g, s),
                lambda: torch.ops.aten.convolution_backward(
                    gl, xl, wl, None, [s, s], [1, 1], [1, 1], False, [0, 0],
                    c, [True, True, False])))
            del x, wt, g, xl, gl
        rows["depthwise_conv3x3_backward"].append(row)
        emit("kernel_vs_plain", name="depthwise_conv3x3_backward", **row)

    def fused_inputs(m, ci, co):
        return (torch.randn(m, ci, generator=gen).cuda(),
                (torch.randn(ci, co, generator=gen) / math.sqrt(ci)).cuda(),
                (torch.randn(m, co, generator=gen) * 2).cuda(),
                torch.randn(m, co, generator=gen).cuda(),
                rand_chan(torch, co, gen))

    cases = [(BATCH * h * h, ci, co, act, h, k)
             for h, ci, co, act, k in fused_shapes()]
    cases += [(m, ci, co, act, 0, 0) for m, ci, co in ODD_FUSED
              for act in (True, False)]
    for m, ci, co, act, h, layers in cases:
        err_f, err_b = check_fused(torch, fi, *fused_inputs(m, ci, co), act,
                                   (f32, bf))
        base = {"shape": [m, ci, co], "act": act, "layers": layers}
        frow = dict(base, max_abs_err=err_f)
        brow = dict(base, max_abs_err=err_b)
        if layers:
            mt = TRAIN_BATCH * h * h
            x, wt, y, g, chan = fused_inputs(mt, ci, co)
            x, wt, y, g = x.to(bf), wt.to(bf), y.to(bf), g.to(bf)
            frow["max_abs_err_b128"], brow["max_abs_err_b128"] = check_fused(
                torch, fi, x, wt, y, g, chan, act, (bf,))
            t = fi.grad_conv_out(g, y, chan, act).to(bf)
            wtt = wt.t()
            xt = x.t()
            flops = 2 * mt * ci * co
            # No atomics: a second launch on the same inputs gives the
            # same bits, forward and backward.
            first = fi.fused_ir_forward(x, wt) + fi.fused_ir_backward(
                x, g, y, wt, chan, act)
            again = fi.fused_ir_forward(x, wt) + fi.fused_ir_backward(
                x, g, y, wt, chan, act)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(first, again)),
                  f"fused_ir {(mt, ci, co, act)}: two launches on the same "
                  "inputs differ")
            del first, again
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            fplan = fi.forward_plan(mt, ci, co, bf, sms)
            bplan = fi.backward_plan(mt, ci, co, bf, sms)
            frow.update(design=fplan.design, plan=dataclasses.asdict(fplan))
            brow.update(design=bplan.design, plan=dataclasses.asdict(bplan))
            # Forward: x and w read, y and the [2, Co] f32 sums written.
            frow.update(b128_times(
                torch, (mt * ci + ci * co + mt * co) * 2 + 2 * co * 4,
                flops / BF16_FLOP_PER_S * 1e3,
                lambda: fi.fused_ir_forward(x, wt),
                lambda: fi.fused_ir_forward_reference(x, wt),
                lambda: torch.matmul(x, wt)))
            # Backward: x, g, y, w, chan read; dx and the f32 dw written.
            brow.update(b128_times(
                torch, (2 * mt * ci + 2 * mt * co + ci * co) * 2
                + 6 * co * 4 + ci * co * 4,
                2 * flops / BF16_FLOP_PER_S * 1e3,
                lambda: fi.fused_ir_backward(x, g, y, wt, chan, act),
                lambda: fi.fused_ir_backward_reference(x, g, y, wt, chan, act),
                lambda: (torch.matmul(t, wtt), torch.matmul(xt, t))))
            for row in (frow, brow):
                # Shares of the memory and bf16 tensor-core rates the
                # kernel reaches (the backward's split of t doubles its
                # tensor-core work; the share counts the two products).
                row.update(hbm_share=row["bytes_ms"] / row["kernel_ms"],
                           tensor_share=row["ops_ms"] / row["kernel_ms"])
            del x, wt, y, g, t, wtt, xt
        rows["fused_ir_forward"].append(frow)
        rows["fused_ir_backward"].append(brow)
        emit("kernel_vs_plain", name="fused_ir_forward", **frow)
        emit("kernel_vs_plain", name="fused_ir_backward", **brow)
    return rows


def b128_times(torch, nbytes, ops_ms, kernel, plain, library) -> dict:
    """Device ms (cold L2) of the kernel's wrapper, its plain version and
    the library call, and the bound: the larger of ``nbytes`` over the
    memory rate and ``ops_ms``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"batch": TRAIN_BATCH,
            "kernel_ms": time_ms(torch, kernel, reps=20),
            "plain_ms": time_ms(torch, plain, reps=10, warmup=2),
            "library_ms": time_ms(torch, library, reps=20),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


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


class plain_versions:
    """Context manager: the training kernels' wrappers replaced by their
    plain versions (on the card) for the model's autograd Functions; the
    kernel path is restored on exit. Used only to compare."""

    def __enter__(self):
        from tpunet_torch.ops import depthwise as dw
        from tpunet_torch.ops import fused_ir as fi

        def dw_bwd(x, w, g, stride):
            dx, dwt = dw.depthwise_conv3x3_backward_reference(x, w, g, stride)
            return dx, dwt.to(w.dtype)

        from tpunet_torch.ops import flash as fl

        def fl_fwd(q, k, v, *, causal=False, scale=None, segment_ids=None,
                   with_lse=False):
            out, lse = fl.flash_attention_forward_reference(
                q, k, v, causal=causal, scale=scale, segment_ids=segment_ids)
            return (out, lse) if with_lse else out

        self.saved = [(dw, "depthwise_conv3x3", dw.depthwise_conv3x3),
                      (dw, "depthwise_conv3x3_backward",
                       dw.depthwise_conv3x3_backward),
                      (fi, "fused_ir_forward", fi.fused_ir_forward),
                      (fi, "fused_ir_backward", fi.fused_ir_backward),
                      (fl, "flash_attention_forward",
                       fl.flash_attention_forward),
                      (fl, "flash_attention_dq", fl.flash_attention_dq),
                      (fl, "flash_attention_dkv", fl.flash_attention_dkv)]
        dw.depthwise_conv3x3 = dw.depthwise_conv3x3_reference
        dw.depthwise_conv3x3_backward = dw_bwd
        fi.fused_ir_forward = fi.fused_ir_forward_reference
        fi.fused_ir_backward = fi.fused_ir_backward_reference
        fl.flash_attention_forward = fl_fwd
        fl.flash_attention_dq = fl.flash_attention_dq_reference
        fl.flash_attention_dkv = fl.flash_attention_dkv_reference
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _counted():
    from tpunet_torch.ops import depthwise as dw
    from tpunet_torch.ops import flash as fl
    from tpunet_torch.ops import fused_ir as fi
    return (dw.depthwise_conv3x3, dw.depthwise_conv3x3_backward,
            fi.fused_ir_forward, fi.fused_ir_backward,
            fl.flash_attention_forward, fl.flash_attention_dq,
            fl.flash_attention_dkv)


def launch_counts():
    return {fn.__name__: fn.launches for fn in _counted()}


def reset_launch_counts():
    for fn in _counted():
        fn.launches = 0


def grad_step(torch, model, augment, images_u8, labels, seed):
    """Loss, parameter gradients and BN running statistics of one train
    forward/backward (no update), from a step generator of ``seed``."""
    import torch.nn.functional as F

    from tpunet_torch.utils.prng import step_generator

    model.zero_grad(set_to_none=True)
    gen = step_generator(seed, 0)
    x = augment(gen, images_u8).permute(0, 3, 1, 2)
    loss = F.cross_entropy(model(x, train=True, generator=gen), labels)
    loss.backward()
    grads = {k: p.grad.detach().float().clone()
             for k, p in model.named_parameters()}
    stats = {k: v.detach().float().clone() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    torch.cuda.synchronize()
    return loss.item(), grads, stats


def grad_errors(torch, got, want) -> dict:
    """Per parameter, ||got - want|| / ||want|| (L2). A BN bias whose
    output reaches the loss only through linear convs into train-mode BNs
    (every project BN's: the residual sum feeds the next expand conv and
    its BN) has a true gradient of 0, since each BN subtracts its batch
    mean and a per-channel shift cancels; what is computed there is
    rounding noise of sum(g). A bias is therefore measured against the
    larger of its own gradient and its BN weight's, sum(g*yhat)."""
    def scale(k):
        norm = want[k].norm()
        w = k[:-5] + ".weight"
        if k.endswith(".bias") and w in want and want[w].shape == want[k].shape:
            norm = torch.maximum(norm, want[w].norm())
        return norm.clamp_min(1e-30)
    return {k: ((got[k] - want[k]).norm() / scale(k)).item() for k in want}


def stat_errors(torch, got, want) -> dict:
    """Per BN, the batch statistics behind the running ones after one
    update from (mean 0, var 1): |d mean| / std and |d var| / var, maxed
    over channels."""
    out = {}
    for k in want:
        if not k.endswith("running_mean"):
            continue
        v = k[:-4] + "var"
        var = (want[v] - 0.9) / 0.1
        dm = (got[k] - want[k]).abs() / 0.1
        dv = (got[v] - want[v]).abs() / 0.1
        out[k[:-13]] = max((dm / (var + 1e-5).sqrt()).max().item(),
                           (dv / (var + 1e-5)).max().item())
    return out


def profile_step(torch, step, wall_ms: float,
                 family_names=("depthwise3x3_fwd", "depthwise3x3_bwd",
                               "fused_ir_fwd", "fused_ir_bwd")) -> dict:
    """Device time of one train step by kernel, from torch.profiler's CUDA
    activity (kernels, copies and fills; not the GPU user annotations,
    see device_activity), and the card's idle share against the step's
    wall time (measured without the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kernels, excluded = device_activity(prof)
    if not kernels:
        return {"device_ms": "not measured (no CUDA events in the trace)"}
    by_name = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(t for _, t in by_name.values())
    families = dict.fromkeys(family_names, 0.0)
    for name, (_, t) in by_name.items():
        for fam in families:
            if fam in name:
                families[fam] += t
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"device_ms": busy, "device_kernels": len(kernels),
            "annotations_left_out_ms": excluded, "hand_kernel_ms": families,
            "wall_ms": wall_ms,
            "device_idle_share": 1.0 - busy / wall_ms,
            "top_kernels": [{"name": n[:90], "calls": c, "ms": t}
                            for n, (c, t) in top]}


def phase_train(torch):
    """The training main path at full width; returns its launch counts."""
    import copy

    import numpy as np

    from tpunet_torch.config import DataConfig, ModelConfig, OptimConfig
    from tpunet_torch.data import synthetic_cifar10
    from tpunet_torch.data.augment import make_train_augment
    from tpunet_torch.models import create_model
    from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
    from tpunet_torch.train.steps import make_train_step
    from tpunet_torch.utils.prng import step_generator

    data, optim = DataConfig(dataset="synthetic"), OptimConfig()
    images, labels = synthetic_cifar10(n_train=TRAIN_BATCH, n_test=1)[:2]
    xb = torch.from_numpy(images).cuda()
    yb = torch.from_numpy(labels.astype(np.int64)).cuda()
    augment = make_train_augment(data)

    def make(dtype, kernels=True):
        cfg = ModelConfig(use_pallas_depthwise=kernels, fused_ir=kernels,
                          dtype=dtype)              # width 1.0
        return create_model(cfg, device="cuda",
                            generator=torch.Generator().manual_seed(42))

    def both_paths(model):
        """(kernels, plain versions): loss, gradients, running statistics
        of one step from the same weights, batch and draws."""
        start = copy.deepcopy(model.state_dict())
        grad_step(torch, model, augment, xb, yb, 7)           # warm-up
        model.load_state_dict(start)
        kern = grad_step(torch, model, augment, xb, yb, 7)
        model.load_state_dict(start)
        with plain_versions():
            plain = grad_step(torch, model, augment, xb, yb, 7)
        model.load_state_dict(start)
        return kern, plain

    # One step, kernels against the plain versions on the card: first in
    # float32 (TF32 off), then in bf16, the main path's type. The backward
    # through 52 train-mode BNs of a randomly initialised net amplifies a
    # rounding difference many thousand times, so the yardstick is a
    # third path with the same weights: fused_ir and the depthwise kernels
    # off (cuDNN's depthwise conv, F.conv2d for the 1x1s, BN in torch).
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    (k_loss, k_grads, k_stats), (p_loss, f32_grads, p_stats) = both_paths(
        make("float32"))
    lib_model = make("float32", kernels=False)
    l_loss, l_grads, l_stats = grad_step(torch, lib_model, augment, xb, yb, 7)
    del lib_model
    g_err = grad_errors(torch, k_grads, f32_grads)
    g_lib = grad_errors(torch, l_grads, f32_grads)
    s_err = stat_errors(torch, k_stats, p_stats)
    s_lib = stat_errors(torch, l_stats, p_stats)
    worst = sorted(g_err, key=g_err.get, reverse=True)
    worst_s = max(s_err, key=s_err.get)
    f32 = dict(loss_kernel=k_loss, loss_plain=p_loss, loss_library=l_loss,
               loss_rel_err=abs(k_loss - p_loss) / abs(p_loss),
               grad_err_worst={k: g_err[k] for k in worst[:4]},
               grad_err_median=statistics.median(g_err.values()),
               grad_err_max=g_err[worst[0]],
               library_grad_err_median=statistics.median(g_lib.values()),
               library_grad_err_max=max(g_lib.values()),
               bn_stat_err_max=s_err[worst_s], bn_stat_err_max_key=worst_s,
               library_bn_stat_err_max=max(s_lib.values()))
    emit("train_grad_check_f32", **f32)
    # Float32 tolerances: loss within 1e-5 relative; the kernels' gradient
    # and BN-statistic errors against the plain versions (median and max
    # over parameters, units in grad_errors/stat_errors) at most twice
    # the library path's, plus 1e-5.
    check(math.isfinite(k_loss) and f32["loss_rel_err"] <= 1e-5,
          f"f32 train loss kernel {k_loss} vs plain {p_loss}")
    for name, ours, lib in (
            ("gradient median", f32["grad_err_median"],
             f32["library_grad_err_median"]),
            ("gradient max", f32["grad_err_max"], f32["library_grad_err_max"]),
            ("BN statistic max", f32["bn_stat_err_max"],
             f32["library_bn_stat_err_max"])):
        check(ours <= 2 * lib + 1e-5, f"f32 {name} error {ours:.3g} against "
              f"the plain versions; the library path's is {lib:.3g}")

    # The world-1 references of phase_dp_step: this f32 kernel step and
    # the library path's distance from it.
    dp_ref = dict(grads=k_grads, stats=k_stats, lib_grads=l_grads,
                  lib_stats=l_stats)
    torch.backends.cudnn.allow_tf32 = True      # a user's defaults again
    model = make("bfloat16")
    start = copy.deepcopy(model.state_dict())
    (k_loss, k_grads, k_stats), (p_loss, p_grads, p_stats) = both_paths(model)
    lib_model = make("bfloat16", kernels=False)
    l_loss, l_grads, l_stats = grad_step(torch, lib_model, augment, xb, yb, 7)
    del lib_model
    s_err = stat_errors(torch, k_stats, p_stats)
    worst_s = max(s_err, key=s_err.get)
    # In bf16 the gradients of this randomly initialised net are mostly
    # rounding noise through the BN backward: the plain versions' and the
    # library path's bf16 gradients are as far from the float32 ones as
    # the gradients are long. Their distances are printed as readings and
    # gate nothing; the kernels at the main path's bf16 inputs are held to
    # their plain versions in phase_train_kernels.
    def to_f32(grads):
        return statistics.median(grad_errors(torch, grads, f32_grads).values())

    bf = dict(loss_kernel=k_loss, loss_plain=p_loss, loss_library=l_loss,
              loss_rel_err=abs(k_loss - p_loss) / abs(p_loss),
              grad_err_vs_f32_median_kernel=to_f32(k_grads),
              grad_err_vs_f32_median_plain=to_f32(p_grads),
              grad_err_vs_f32_median_library=to_f32(l_grads),
              grad_err_kernel_vs_plain_median=statistics.median(
                  grad_errors(torch, k_grads, p_grads).values()),
              bn_stat_err_max=s_err[worst_s], bn_stat_err_max_key=worst_s,
              library_bn_stat_err_max=max(
                  stat_errors(torch, l_stats, p_stats).values()))
    emit("train_grad_check_bf16", **bf)
    # bf16 tolerances: loss within 2^-7 relative (a few bf16 ulps); the
    # BN-statistic error against the plain versions at most twice the
    # library path's plus 2^-10.
    check(math.isfinite(k_loss) and bf["loss_rel_err"] <= 2.0**-7,
          f"bf16 train loss kernel {k_loss} vs plain {p_loss}")
    check(bf["bn_stat_err_max"] <= 2 * bf["library_bn_stat_err_max"] + 2.0**-10,
          f"bf16 BN statistic {worst_s}: error {bf['bn_stat_err_max']:.3g}; "
          f"the library path's is {bf['library_bn_stat_err_max']:.3g}")

    # The main path: the train step as the trainer calls it, on one
    # repeated batch, with every launch count at 0 before it.
    state = TrainState(model, make_optimizer(model.parameters(), optim),
                       lr_schedule(optim, 1, 20))
    step_fn = make_train_step(data, optim)
    step_fn(state, xb, yb, step_generator(42, 10_000))     # warm-up
    torch.cuda.synchronize()
    model.load_state_dict(start)
    state = TrainState(model, make_optimizer(model.parameters(), optim),
                       lr_schedule(optim, 1, 20))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step_fn(state, xb, yb, step_generator(42, state.global_step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss_sum"]) / TRAIN_BATCH)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"depthwise_conv3x3": 17, "depthwise_conv3x3_backward": 17,
            "fused_ir_forward": 33, "fused_ir_backward": 33}
    for name, per_step in want.items():
        check(launches[name] == per_step * TRAIN_STEPS,
              f"{name}: {launches[name]} launches in {TRAIN_STEPS} steps "
              f"(want {per_step} a step)")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over {TRAIN_STEPS} "
          f"steps on one batch: {losses[0]} -> {losses[-1]}")
    from tpunet_torch.ops import depthwise as dw
    from tpunet_torch.ops import fused_ir as fi
    steady = sorted(times[2:])
    p50 = statistics.median(steady)
    emit("train_main_path", width_mult=1.0, image_size=224, batch=TRAIN_BATCH,
         steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         step_ms_p50=p50 * 1e3, step_ms_min=steady[0] * 1e3,
         step_ms_max=steady[-1] * 1e3, images_per_s=TRAIN_BATCH / p50,
         peak_memory_bytes=peak,
         grad_layout_copies={"depthwise": dw.grad_layout_copies,
                             "fused_ir": fi.grad_layout_copies})
    prof = profile_step(torch, lambda: step_fn(
        state, xb, yb, step_generator(42, state.global_step)), p50 * 1e3)
    emit("train_step_profile", **prof)
    return launches, TRAIN_BATCH / p50, dict(dp_ref, bf16_loss=losses[0],
                                             step_ms=p50 * 1e3)


TRAIN_B512 = 512   # a batch whose 112 px rows pass grid y's 65,535 tiles


def phase_train_b512(torch) -> dict:
    """One MobileNetV2 train step at batch 512 (width 1.0, 224 px, bf16
    over f32, the hand kernels): its 112 px fused-IR layers have
    512 x 112 x 112 / 64 = 100,352 row tiles. The loss must be finite,
    the step must launch 17 + 17 + 33 + 33 kernels, and its peak memory
    must fit the card; the peak is printed."""
    import numpy as np

    from tpunet_torch.config import DataConfig, ModelConfig, OptimConfig
    from tpunet_torch.data import synthetic_cifar10
    from tpunet_torch.models import create_model
    from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
    from tpunet_torch.train.steps import make_train_step
    from tpunet_torch.utils.prng import step_generator

    data, optim = DataConfig(dataset="synthetic"), OptimConfig()
    images, labels = synthetic_cifar10(n_train=TRAIN_B512, n_test=1)[:2]
    xb = torch.from_numpy(images).cuda()
    yb = torch.from_numpy(labels.astype(np.int64)).cuda()
    model = create_model(ModelConfig(use_pallas_depthwise=True,
                                     fused_ir=True),
                         device="cuda",
                         generator=torch.Generator().manual_seed(42))
    state = TrainState(model, make_optimizer(model.parameters(), optim),
                       lr_schedule(optim, 1, 20))
    step_fn = make_train_step(data, optim)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    m = step_fn(state, xb, yb, step_generator(42, 0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    loss = float(m["loss_sum"]) / TRAIN_B512
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.mem_get_info()[1]
    del model, state, m, xb, yb
    torch.cuda.empty_cache()
    out = dict(batch=TRAIN_B512, loss=loss, step_wall_s=wall,
               launches=launches, peak_memory_bytes=peak,
               card_memory_bytes=total, fused_ir_row_tiles_112px=-(
                   -TRAIN_B512 * 112 * 112 // 64))
    emit("train_b512", **out)
    check(math.isfinite(loss), f"batch-512 loss {loss}")
    want = {"depthwise_conv3x3": 17, "depthwise_conv3x3_backward": 17,
            "fused_ir_forward": 33, "fused_ir_backward": 33}
    check(all(launches[k] == v for k, v in want.items()),
          f"batch-512 step launches {launches}")
    check(peak <= total, f"batch-512 peak {peak} bytes > the card's {total}")
    return out


def phase_trainer(torch, model_cfg=None, cli_flags=("--pallas-depthwise",),
                  tag="trainer", sync_step_ms=None,
                  window_kernels=MNV2_WINDOW_KERNELS, exporters=False):
    """Trainer.train() for one epoch at full width with obs on (the
    default), the best .pth loaded back and evaluated, then --eval-only
    through the CLI; its obs_epoch record checked (check_obs_epoch).
    Then the same epoch with --no-obs and with a 2-step profile window:
    the syncs of the three (check_syncs), the window's trace
    (check_window). With ``exporters`` the window epoch runs through the
    CLI in this process with --statsd, --obs-http (to listeners here) and
    --obs-rule 'mfu > 0' (check_exports)."""
    import dataclasses
    import re

    from tpunet_torch.config import (CheckpointConfig, DataConfig,
                                     ModelConfig, ObsConfig, TrainConfig)
    from tpunet_torch.models import create_model
    from tpunet_torch.models.convert import load_state_dict_file
    from tpunet_torch.train import __main__ as cli
    from tpunet_torch.train.loop import Trainer

    if model_cfg is None:
        model_cfg = ModelConfig(use_pallas_depthwise=True, fused_ir=True)
    ckdir = ROOT / "build" / "tpunet_torch" / f"smoke_{tag}"
    shutil.rmtree(ckdir, ignore_errors=True)
    cfg = TrainConfig(
        epochs=1,
        data=DataConfig(dataset="synthetic", synthetic_train_size=1024,
                        synthetic_test_size=256, batch_size=TRAIN_BATCH),
        model=model_cfg, checkpoint=CheckpointConfig(directory=str(ckdir)))
    t0 = time.perf_counter()
    # Each run's memory figures are its own: the allocator's peak since
    # the reset.
    torch.cuda.reset_peak_memory_stats()
    with SyncCounter(torch) as on_sync:
        trainer = Trainer(cfg, device="cuda")
        try:
            history = trainer.train()
        finally:
            trainer.close()
    wall = time.perf_counter() - t0
    check(len(history) == 1, f"{len(history)} epoch records")
    rec = history[0]
    check(all(math.isfinite(rec[k]) for k in ("train_loss", "test_loss")),
          f"non-finite epoch record {rec}")
    best = ckdir / "best.pth"
    check(best.exists() and (ckdir / "state.pt").exists()
          and (ckdir / "metrics.jsonl").exists(), f"files in {ckdir}: "
          f"{sorted(p.name for p in ckdir.iterdir())}")
    records = read_records(ckdir)
    obs = check_obs_epoch(torch, tag, trainer, records)
    del trainer
    again = Trainer(dataclasses.replace(cfg, eval_only=True), device="cuda")
    model = create_model(cfg.model, device="cuda")
    load_state_dict_file(str(best), model)
    again.state.model.load_state_dict(model.state_dict())
    acc = again.evaluate()["accuracy"]
    again.close()
    del again, model
    check(acc == rec["test_accuracy"], f"best.pth evaluates to {acc}, the "
          f"epoch measured {rec['test_accuracy']}")
    out = subprocess.run(
        [sys.executable, "-m", "tpunet_torch.train", "--preset", "single",
         "--dataset", "synthetic", "--synthetic-size", "1024",
         *cli_flags, "--checkpoint-dir", str(ckdir), "--eval-only"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"--eval-only exited {out.returncode}: "
          f"{out.stderr[-2000:]}")
    found = re.search(r"Eval: Test Loss: (\S+) Test Acc: (\S+)", out.stdout)
    check(found is not None, f"--eval-only printed no Eval line: {out.stdout}")
    cli_acc = float(found.group(2))
    check(abs(cli_acc - rec["test_accuracy"]) < 5e-5,
          f"--eval-only accuracy {cli_acc} vs {rec['test_accuracy']}")

    # The same epoch with --no-obs, then with the profile window.
    off_dir, win_dir = ckdir.with_name(ckdir.name + "_no_obs"), \
        ckdir.with_name(ckdir.name + "_window")
    for d in (off_dir, win_dir):
        shutil.rmtree(d, ignore_errors=True)
    with SyncCounter(torch) as off_sync:
        off = Trainer(dataclasses.replace(
            cfg, checkpoint=CheckpointConfig(directory=str(off_dir)),
            obs=ObsConfig(enabled=False)), device="cuda")
        try:
            off.train()
        finally:
            off.close()
    del off
    off_records = read_records(off_dir)
    check(len(off_records) == 1 and "kind" not in off_records[0],
          f"{tag}: the --no-obs run wrote {off_records}")
    sent = None
    torch.cuda.reset_peak_memory_stats()
    with SyncCounter(torch) as win_sync:
        if exporters:
            with ExportListeners() as listeners:
                win = cli.run(["--preset", "single", "--dataset",
                               "synthetic", "--synthetic-size", "1024",
                               "--epochs", "1", *cli_flags,
                               "--checkpoint-dir", str(win_dir),
                               *OBS_WINDOW, *listeners.flags,
                               "--obs-rule", "mfu > 0"])
            sent = check_exports(tag, listeners, read_records(win_dir))
        else:
            win = Trainer(dataclasses.replace(
                cfg, checkpoint=CheckpointConfig(directory=str(win_dir)),
                obs=ObsConfig(profile_start_step=int(OBS_WINDOW[1]),
                              profile_num_steps=int(OBS_WINDOW[3]))),
                device="cuda")
            try:
                win.train()
            finally:
                win.close()
    win_records = read_records(win_dir)
    win_obs = check_obs_epoch(torch, f"{tag} window", win, win_records)
    del win
    window = check_window(tag, win_dir, window_kernels)
    syncs = check_syncs(tag, on_sync, off_sync, win_sync)
    emit(tag, epoch_record=rec, wall_s=wall, best_pth_accuracy=acc,
         eval_only_line=found.group(0))
    rate = f"{obs['unit']}_per_sec"
    emit(f"{tag}_obs", obs_epoch=obs, sync_step_ms_p50=sync_step_ms,
         step_lap_p50_ms=obs["step_time_p50_ms"],
         obs_epoch_per_sec={"obs_on": obs["units_per_sec"],
                            "window": win_obs["units_per_sec"]},
         epoch_record_per_sec={"obs_on": rec[rate],
                               "no_obs": plain_records(off_dir)[0][rate],
                               "window": plain_records(win_dir)[0][rate]},
         syncs=syncs, window=window,
         exports=sent, summary=summarize_run(records))
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# The trainer's observability (tpunet_torch/obs)
# ---------------------------------------------------------------------------



class SyncCounter:
    """Counts ``torch.cuda.synchronize`` calls while installed: all of
    them (``calls``), and those made from tpunet_torch's own code
    (``port``; torch.profiler's stop also synchronizes, inside torch)."""

    def __init__(self, torch):
        self.torch, self.calls, self.port = torch, 0, 0

    def __enter__(self):
        real = self.real = self.torch.cuda.synchronize

        def counted(*args, **kw):
            self.calls += 1
            caller = sys._getframe(1).f_globals.get("__name__", "")
            self.port += caller.startswith("tpunet_torch")
            return real(*args, **kw)

        self.torch.cuda.synchronize = counted
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize = self.real


def read_records(ckdir) -> list:
    """The records of ``<ckdir>/metrics.jsonl``."""
    lines = (Path(ckdir) / "metrics.jsonl").read_text().splitlines()
    return [json.loads(line) for line in lines if line.strip()]


def plain_records(ckdir) -> list:
    """The plain epoch records (no ``kind``) of a run."""
    return [r for r in read_records(ckdir) if "kind" not in r]


def obs_epoch_fields() -> set:
    """The fields docs/metrics_schema.md documents for ``obs_epoch``, with
    the identity fields every record carries (the schema checker's
    ``parse_schema``, which needs no JAX)."""
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        from check_metrics_schema import parse_schema
    finally:
        sys.path.pop(0)
    _, fields, global_fields = parse_schema()
    return fields["obs_epoch"] | global_fields | {"kind"}


def check_obs_epoch(torch, tag, trainer, records) -> dict:
    """The run's one ``obs_epoch`` record: its steps and step-time
    sample, finite percentiles, documented fields only, MFU against the
    formula, the card's memory, and the trainer's gauges."""
    from tpunet_torch.models import num_params
    from tpunet_torch.obs.perf import train_flops_per_unit

    obs = [r for r in records if r.get("kind") == "obs_epoch"]
    check(len(obs) == 1, f"{tag}: {len(obs)} obs_epoch records")
    rec = obs[0]
    unit = "tokens" if trainer.cfg.is_lm else "examples"
    rate = rec[f"{unit}_per_sec"]
    check(rec["unit"] == unit and rec["steps"] == trainer.spe
          and len(rec.get("step_time_sample", ())) == trainer.spe,
          f"{tag}: obs_epoch steps {rec['steps']}, "
          f"{len(rec.get('step_time_sample', ()))} samples; the epoch has "
          f"{trainer.spe} {unit} steps")
    check(all(math.isfinite(rec[f"step_time_{q}_s"])
              for q in ("p50", "p90", "p99")), f"{tag}: percentiles {rec}")
    extra = sorted(set(rec) - obs_epoch_fields())
    check(not extra, f"{tag}: obs_epoch fields docs/metrics_schema.md does "
          f"not document: {extra}")
    flops = train_flops_per_unit(trainer.cfg.model, trainer.cfg.data,
                                 num_params(trainer.state.model))
    # MFU against its formula over one card (world 1): the gauge within
    # 1e-3 relative; the record, rounded to 4 decimals, within the larger
    # of 1e-3 relative and its rounding.
    want = rate * flops / (BF16_FLOP_PER_S * 1)
    reg = trainer.obs.registry
    gauge = reg.gauge("mfu").value
    mfu = rec.get("mfu")
    check(mfu is not None and 0 < mfu < 1
          and abs(mfu - want) <= max(1e-3 * want, 5e-5)
          and gauge is not None and abs(gauge - want) <= 1e-3 * want,
          f"{tag}: mfu {mfu} (gauge {gauge}); {rate} {unit}/s x {flops} "
          f"FLOP / 989e12 = {want}")
    mem = rec["device_memory"]
    check(len(mem) == 1 and 0 < mem[0].get("bytes_in_use", 0)
          <= mem[0].get("peak_bytes_in_use", 0)
          <= mem[0].get("bytes_limit", 0)
          and reg.gauge("mem_peak_bytes_in_use").value
          == mem[0]["peak_bytes_in_use"],
          f"{tag}: device_memory {mem}, mem_peak_bytes_in_use gauge "
          f"{reg.gauge('mem_peak_bytes_in_use').value}")
    return dict(step_time_p50_ms=rec["step_time_p50_s"] * 1e3,
                step_time_p99_ms=rec["step_time_p99_s"] * 1e3,
                units_per_sec=rate, unit=unit, mfu=mfu, mfu_gauge=gauge,
                mfu_formula=want, flops_per_unit=flops,
                peak_bytes_in_use=mem[0]["peak_bytes_in_use"],
                bytes_limit=mem[0]["bytes_limit"],
                stall_frac=rec["stall_frac"],
                train_seconds=rec["train_seconds"])


def check_window(tag, ckdir, kernels) -> dict:
    """A window epoch's trace: one file, exactly 2 ``train`` step
    regions, and the path's hand kernels among its kernels."""
    traces = sorted((Path(ckdir).resolve() / "profile").glob(
        "*.pt.trace.json"))
    check(len(traces) == 1, f"{tag}: traces {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    steps = [e for e in events if e.get("name") == "train"
             and e.get("cat") == "user_annotation"]
    check(len(steps) == 2, f"{tag}: the window holds {len(steps)} train "
          "step regions (want 2)")
    labels = {}
    for e in events:
        if e.get("cat") == "kernel":
            label = kernel_label(e["name"])
            labels[label] = labels.get(label, 0) + 1
    found = {k: sum(n for label, n in labels.items() if k in label)
             for k in kernels}
    check(all(found.values()), f"{tag}: hand kernels in the window's trace "
          f"{found}")
    return dict(trace=str(traces[0].relative_to(ROOT)),
                trace_bytes=traces[0].stat().st_size,
                train_regions=len(steps), kernels=sum(labels.values()),
                hand_kernels=found)


def check_syncs(tag, on, off, window) -> dict:
    """An obs-on epoch issues as many port syncs as a --no-obs one; a
    window epoch 2 more (its two edge fences)."""
    counts = {"obs_on": on.port, "no_obs": off.port, "window": window.port,
              "all_calls": {"obs_on": on.calls, "no_obs": off.calls,
                            "window": window.calls}}
    check(on.port == off.port and window.port == on.port + 2,
          f"{tag}: torch.cuda.synchronize calls from tpunet_torch {counts}")
    return counts


def summarize_run(records) -> dict:
    """tpunet_torch.obs.summary.summarize over a run's records (this host
    has no JAX, so tpunet.obs cannot import here): its step-time
    figures."""
    from tpunet_torch.obs.summary import summarize

    s = summarize(records)
    return dict(totals=s["totals"], step_time_p50_s=[
        r.get("step_time_p50_s") for r in s["obs_epochs"]])


class ExportListeners:
    """A UDP socket (statsd) and an HTTP listener (line-JSON) on
    127.0.0.1, each collecting what it receives on a thread."""

    def __enter__(self):
        import socket
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.udp_lines, self.http_lines = [], []
        self.udp = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.udp.bind(("127.0.0.1", 0))
        self.udp.settimeout(0.2)
        self._stop = threading.Event()
        sink = self.http_lines

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                sink.extend(self.rfile.read(n).decode().splitlines())
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._threads = [threading.Thread(target=self._recv, daemon=True),
                         threading.Thread(target=self.httpd.serve_forever,
                                          daemon=True)]
        for th in self._threads:
            th.start()
        return self

    def _recv(self):
        while not self._stop.is_set():
            try:
                data = self.udp.recv(65536)
            except OSError:
                continue
            self.udp_lines.extend(data.decode().splitlines())

    @property
    def flags(self):
        return ("--statsd", f"127.0.0.1:{self.udp.getsockname()[1]}",
                "--obs-http", f"http://127.0.0.1:{self.httpd.server_port}/")

    def __exit__(self, *exc):
        time.sleep(0.5)       # datagrams in flight on the loopback
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for th in self._threads:
            th.join(timeout=5)
        self.udp.close()


def check_exports(tag, listeners, records) -> dict:
    """The statsd line of the epoch's MFU, the obs_epoch line over HTTP,
    and the ``mfu > 0`` rule's alert after the obs_epoch record."""
    mfu_lines = [line for line in listeners.udp_lines
                 if re.match(r"tpunet\.obs_epoch\.mfu:[-+.e0-9]+\|g(\||$)",
                             line)]
    http_kinds = [json.loads(line).get("kind")
                  for line in listeners.http_lines if line.strip()]
    kinds = [(r.get("kind"), r.get("reason")) for r in records]
    epoch_at = kinds.index(("obs_epoch", None)) \
        if ("obs_epoch", None) in kinds else None
    alert_at = [i for i, k in enumerate(kinds)
                if k == ("obs_alert", "gauge_predicate")]
    check(bool(mfu_lines), f"{tag}: no tpunet.obs_epoch.mfu gauge line in "
          f"{len(listeners.udp_lines)} statsd lines")
    check("obs_epoch" in http_kinds, f"{tag}: HTTP kinds {http_kinds}")
    check(epoch_at is not None and any(i > epoch_at for i in alert_at),
          f"{tag}: no gauge_predicate obs_alert after the obs_epoch record "
          f"in {kinds}")
    return dict(statsd_lines=len(listeners.udp_lines),
                statsd_mfu_line=mfu_lines[0], http_lines=len(http_kinds),
                http_kinds=sorted(set(http_kinds) - {None}),
                rule_alerts=len(alert_at))


# ---------------------------------------------------------------------------
# Data parallelism
# ---------------------------------------------------------------------------

DP_DIR = ROOT / "build" / "tpunet_torch" / "smoke_dp"
DP_STEP_BATCH = TRAIN_BATCH // 2   # per rank: 2 ranks on one card
DP_UPDATES = 3
DP_TIMEOUT_S = 300
# The dp_trainer epoch against the single-process Trainer's: losses within
# 1e-3 relative, accuracies within 0.01 (bf16 steps through cuDNN, whose
# convolution backward need not give the same bits twice).
DP_EPOCH_RTOL = 1e-3
DP_EPOCH_ACC_TOL = 0.01


def run_workers(cmds, env=None) -> list:
    """Run the commands together, stdout and stderr to files under
    DP_DIR; each must exit 0 within DP_TIMEOUT_S, and all are killed on
    any failure. Returns their stdout. A worker finds its rendezvous in
    its arguments or ``env``, never in an inherited MASTER_ADDR."""
    import os
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK")}
    procs = []
    try:
        for name, cmd in cmds:
            out = open(DP_DIR / f"{name}.out", "w")
            err = open(DP_DIR / f"{name}.err", "w")
            procs.append((name, out, err, subprocess.Popen(
                cmd, stdout=out, stderr=err, cwd=ROOT,
                env={**base, **(env or {}).get(name, {})})))
        for name, out, err, p in procs:
            try:
                p.wait(timeout=DP_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise PhaseError(f"{name} did not finish in "
                                 f"{DP_TIMEOUT_S} s") from None
            check(p.returncode == 0, f"{name} exited {p.returncode}: "
                  f"{(DP_DIR / f'{name}.err').read_text()[-3000:]}")
        return [(DP_DIR / f"{name}.out").read_text() for name, _ in cmds]
    finally:
        for name, out, err, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()


def dp_worker(role: str, world: int, rank: int) -> int:
    """One rank of a data-parallel phase (``chip_smoke.py --dp-worker``):

    - ``step``: one of 2 ranks that share the card over gloo (NCCL refuses
      two ranks on one device). On its 64 rows of the seeded batch of 128:
      one f32 kernel step's all-reduced gradients and BN running
      statistics (TF32 off, the generator of phase_train's grad_step),
      then 3 bf16 train-step updates with their launch counts, the first
      step's global loss, and whether both ranks hold the same parameters
      after them;
    - ``time``: one process, 30 bf16 steps at batch 128 on one repeated
      batch in turns without a process group and at world 1 over NCCL
      (none, NCCL, NCCL, none): the wall times, the NCCL runs'
      collective calls and launches, the host time inside the
      all-reduces over 10 more steps, and one profiled step.
    Writes its results to DP_DIR/<role>_rank<rank>.pt."""
    import numpy as np
    import torch
    import torch.distributed as tdist
    import torch.nn.functional as F

    from tpunet_torch.config import DataConfig, ModelConfig, OptimConfig
    from tpunet_torch.data import synthetic_cifar10
    from tpunet_torch.data.augment import make_train_augment
    from tpunet_torch.models import create_model
    from tpunet_torch.parallel import dist
    from tpunet_torch.train import metrics as M
    from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
    from tpunet_torch.train.steps import make_train_step, reduce_gradients
    from tpunet_torch.utils.prng import step_generator

    if role == "step":
        dist.initialize_distributed(
            init_method=(DP_DIR / "store").as_uri(), world_size=world,
            rank=rank, backend="gloo")
    device = dist.local_device()
    torch.cuda.set_device(device)
    data, optim = DataConfig(dataset="synthetic"), OptimConfig()
    images, labels = synthetic_cifar10(n_train=TRAIN_BATCH, n_test=1)[:2]
    n = TRAIN_BATCH // world
    rows = slice(rank * n, (rank + 1) * n)
    xb = torch.from_numpy(images[rows]).to(device)
    yb = torch.from_numpy(labels[rows].astype(np.int64)).to(device)

    def make(dtype):
        return create_model(ModelConfig(use_pallas_depthwise=True,
                                        fused_ir=True, dtype=dtype),
                            device=str(device),
                            generator=torch.Generator().manual_seed(42))

    out = {}
    if role == "step":
        out.update(backend=dist.backend_name(), world=dist.process_count())
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        model = make("float32")
        gen = step_generator(7, 0)
        x = make_train_augment(data)(gen, xb).permute(0, 3, 1, 2)
        loss = F.cross_entropy(model(x, train=True, generator=gen), yb)
        loss.backward()
        reduce_gradients(model.parameters())
        out["f32_grads"] = {k: p.grad.detach().float().cpu()
                            for k, p in model.named_parameters()}
        out["f32_stats"] = {k: v.detach().float().cpu()
                            for k, v in model.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))}
        del model, x, loss
        torch.backends.cudnn.allow_tf32 = True
        model = make("bfloat16")
        state = TrainState(model, make_optimizer(model.parameters(), optim),
                           lr_schedule(optim, 1, 20))
        step_fn = make_train_step(data, optim)
        reset_launch_counts()
        first = None
        for _ in range(DP_UPDATES):
            m = step_fn(state, xb, yb, step_generator(42, state.global_step))
            if first is None:
                first = M.summarize(m)["loss"]   # the global batch's
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out["bf16_loss"] = first
        flat = torch.cat([p.detach().reshape(-1) for p in
                          model.parameters()]).cpu()
        gathered = [torch.empty_like(flat) for _ in range(world)]
        tdist.all_gather(gathered, flat)
        out["params_equal"] = all(torch.equal(gathered[0], g)
                                  for g in gathered[1:])
    else:
        model = make("bfloat16")
        state = TrainState(model, make_optimizer(model.parameters(), optim),
                           lr_schedule(optim, 1, 20))
        step_fn = make_train_step(data, optim)

        def step():
            step_fn(state, xb, yb, step_generator(42, state.global_step))

        def p50_ms():
            times = []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            steady = sorted(times[2:])
            return (statistics.median(steady) * 1e3, steady[0] * 1e3,
                    steady[-1] * 1e3)

        step()                                     # warm-up
        torch.cuda.synchronize()
        runs = {"none_a": p50_ms()}
        dist.initialize_distributed(world_size=1, rank=0)
        out.update(backend=dist.backend_name(), world=dist.process_count())
        step()                                     # the communicator
        torch.cuda.synchronize()
        reset_launch_counts()
        calls = dist.all_reduce.calls
        runs["nccl_a"] = p50_ms()
        out["collectives"] = dist.all_reduce.calls - calls
        out["launches"] = launch_counts()
        runs["nccl_b"] = p50_ms()
        # Host time inside the all-reduces (NCCL returns once the call
        # is queued), over 10 more steps, outside the timed runs.
        spent = [0.0]
        raw = tdist.all_reduce

        def timed_all_reduce(*a, **k):
            t0 = time.perf_counter()
            try:
                return raw(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0

        tdist.all_reduce = timed_all_reduce
        try:
            for _ in range(10):
                step()
            torch.cuda.synchronize()
        finally:
            tdist.all_reduce = raw
        out["collective_host_ms_per_step"] = spent[0] * 1e3 / 10
        out["profile"] = profile_step(
            torch, step, runs["nccl_a"][0], family_names=(
                "nccl", "depthwise3x3_fwd", "depthwise3x3_bwd",
                "fused_ir_fwd", "fused_ir_bwd"))
        dist.destroy()
        runs["none_b"] = p50_ms()
        out["runs"] = runs
    torch.save(out, DP_DIR / f"{role}_rank{rank}.pt")
    dist.destroy()
    return 0


def phase_dp_step(torch, ref) -> None:
    """dp_step: 2 ranks share the card (gloo), 64 rows each of the seeded
    batch of 128, against phase_train's world-1 kernel step on the 128."""
    shutil.rmtree(DP_DIR, ignore_errors=True)
    DP_DIR.mkdir(parents=True)
    me = str(Path(__file__).resolve())
    run_workers([(f"step_rank{r}", [sys.executable, me, "--dp-worker",
                                    "step", "2", str(r)]) for r in range(2)],
                env={f"step_rank{r}": {"LOCAL_RANK": str(r)}
                     for r in range(2)})
    outs = [torch.load(DP_DIR / f"step_rank{r}.pt", weights_only=False)
            for r in range(2)]
    got = outs[0]
    check(all(o["backend"] == "gloo" and o["world"] == 2 for o in outs),
          f"dp_step ran as {[(o['backend'], o['world']) for o in outs]}")
    want = {k: v.float().cpu() for k, v in ref["grads"].items()}
    lib = {k: v.float().cpu() for k, v in ref["lib_grads"].items()}
    g_err = grad_errors(torch, got["f32_grads"], want)
    g_lib = grad_errors(torch, lib, want)
    s_want = {k: v.float().cpu() for k, v in ref["stats"].items()}
    s_err = stat_errors(torch, got["f32_stats"], s_want)
    s_lib = stat_errors(torch, {k: v.float().cpu() for k, v in
                                ref["lib_stats"].items()}, s_want)
    res = dict(ranks=2, backend="gloo", rows_per_rank=DP_STEP_BATCH,
               grad_err_median=statistics.median(g_err.values()),
               grad_err_max=max(g_err.values()),
               library_grad_err_median=statistics.median(g_lib.values()),
               library_grad_err_max=max(g_lib.values()),
               bn_stat_err_max=max(s_err.values()),
               library_bn_stat_err_max=max(s_lib.values()),
               bf16_loss=got["bf16_loss"], bf16_loss_world1=ref["bf16_loss"],
               bf16_loss_rel_err=abs(got["bf16_loss"] - ref["bf16_loss"])
               / abs(ref["bf16_loss"]),
               params_equal_after_updates=got["params_equal"],
               updates=DP_UPDATES,
               launches_per_step=[{k: v / DP_UPDATES for k, v in
                                   o["launches"].items()} for o in outs])
    emit("dp_step", **res)
    # The f32 gate of phase_train: each error against the world-1 kernel
    # step at most twice the library path's distance from it, plus 1e-5.
    for name, ours, lib_err in (
            ("gradient median", res["grad_err_median"],
             res["library_grad_err_median"]),
            ("gradient max", res["grad_err_max"], res["library_grad_err_max"]),
            ("BN statistic max", res["bn_stat_err_max"],
             res["library_bn_stat_err_max"])):
        check(ours <= 2 * lib_err + 1e-5, f"dp_step f32 {name} error "
              f"{ours:.3g} against the world-1 step; the library path's is "
              f"{lib_err:.3g}")
    check(math.isfinite(got["bf16_loss"])
          and res["bf16_loss_rel_err"] <= 2.0**-7,
          f"dp_step bf16 loss {got['bf16_loss']} vs world 1 "
          f"{ref['bf16_loss']}")
    check(got["params_equal"], "the two ranks' parameters differ after "
          f"{DP_UPDATES} updates")
    want_launches = {"depthwise_conv3x3": 17, "depthwise_conv3x3_backward": 17,
                     "fused_ir_forward": 33, "fused_ir_backward": 33}
    for o in outs:
        for name, k in want_launches.items():
            check(o["launches"][name] == k * DP_UPDATES,
                  f"dp_step {name}: {o['launches'][name]} launches in "
                  f"{DP_UPDATES} steps (want {k} a step)")


def phase_dp_trainer(torch, single_epoch, single_step_ms) -> None:
    """dp_trainer: ``python -m tpunet_torch.train --preset distributed`` at
    world 1 over NCCL, one epoch at phase_trainer's sizes, against its
    epoch; --eval-only of the best.pth; then 30 timed steps against
    phase_train's single-process step."""
    ckdir = DP_DIR / "ck"
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    flags = [sys.executable, "-m", "tpunet_torch.train", "--preset",
             "distributed", "--pallas-depthwise", "--dataset", "synthetic",
             "--synthetic-size", "1024", "--epochs", "1",
             "--checkpoint-dir", str(ckdir)]
    t0 = time.perf_counter()
    (out,) = run_workers([("trainer", flags)], env={"trainer": env})
    wall = time.perf_counter() - t0
    check("Processes: 1 (nccl), global batch 128" in out,
          f"the distributed CLI did not report NCCL at world 1: {out[:2000]}")
    plain = plain_records(ckdir)
    check(len(plain) == 1 and (ckdir / "best.pth").exists(),
          f"files in {ckdir}: {sorted(p.name for p in ckdir.iterdir())}")
    rec = plain[0]
    keys = ("train_loss", "train_accuracy", "test_loss", "test_accuracy")
    diff = {k: rec[k] - single_epoch[k] for k in keys}
    bit_equal = all(rec[k] == single_epoch[k] for k in keys)
    (ev,) = run_workers([("eval_only", flags + ["--eval-only"])],
                        env={"eval_only": env})
    found = re.search(r"Eval: Test Loss: (\S+) Test Acc: (\S+)", ev)
    check(found is not None, f"--eval-only printed no Eval line: {ev}")
    me = str(Path(__file__).resolve())
    run_workers([("time_rank0", [sys.executable, me, "--dp-worker", "time",
                                 "1", "0"])])
    timed = torch.load(DP_DIR / "time_rank0.pt", weights_only=False)
    prof, runs = timed["profile"], timed["runs"]
    nccl_ms = prof.get("hand_kernel_ms", {}).get("nccl")
    p50 = statistics.median([runs["nccl_a"][0], runs["nccl_b"][0]])
    none = statistics.median([runs["none_a"][0], runs["none_b"][0]])
    emit("dp_trainer", backend=timed["backend"], epoch_record=rec,
         single_epoch_record={k: single_epoch[k] for k in keys},
         epoch_diff=diff, epoch_bit_equal=bit_equal,
         tolerance={"loss_rel": DP_EPOCH_RTOL, "accuracy": DP_EPOCH_ACC_TOL},
         cli_wall_s=wall, eval_only_line=found.group(0),
         step_ms_runs={k: v[0] for k, v in runs.items()},
         step_ms_p50=p50, images_per_s=TRAIN_BATCH / (p50 / 1e3),
         single_step_ms_p50=none,
         single_images_per_s=TRAIN_BATCH / (none / 1e3),
         phase_train_step_ms_p50=single_step_ms,
         collectives_per_step=timed["collectives"] / TRAIN_STEPS,
         collective_host_ms_per_step=timed["collective_host_ms_per_step"],
         collective_host_share=timed["collective_host_ms_per_step"] / p50,
         step_overhead_share=(p50 - none) / p50,
         launches_per_step={k: v / TRAIN_STEPS
                            for k, v in timed["launches"].items()},
         nccl_device_ms=nccl_ms,
         nccl_device_share=None if nccl_ms is None else nccl_ms / p50,
         profile=prof)
    for k in ("train_loss", "test_loss"):
        check(abs(diff[k]) <= DP_EPOCH_RTOL * abs(single_epoch[k]),
              f"dp_trainer {k} {rec[k]} vs the single Trainer's "
              f"{single_epoch[k]}")
    for k in ("train_accuracy", "test_accuracy"):
        check(abs(diff[k]) <= DP_EPOCH_ACC_TOL, f"dp_trainer {k} {rec[k]} "
              f"vs the single Trainer's {single_epoch[k]}")
    check(abs(float(found.group(2)) - rec["test_accuracy"]) < 5e-5,
          f"--eval-only accuracy {found.group(2)} vs {rec['test_accuracy']}")
    check(timed["backend"] == "nccl", f"timed on {timed['backend']}")
    check(timed["collectives"] == 105 * TRAIN_STEPS,
          f"{timed['collectives']} collectives in {TRAIN_STEPS} steps (want "
          "52 BN forward + 52 BN backward + 1 gradient buffer a step)")
    for name, k in (("depthwise_conv3x3", 17), ("fused_ir_backward", 33)):
        check(timed["launches"][name] == k * TRAIN_STEPS,
              f"dp_trainer {name}: {timed['launches'][name]} launches")


# ---------------------------------------------------------------------------
# Flash attention and ViT-B/16
# ---------------------------------------------------------------------------


def flash_inputs(torch, case, dtype, seed):
    """q, k, v, dO, segment ids and glse of one flash check, on the card."""
    b, tq, tk, h, d, causal, segmented, with_glse = case
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, tq, h, d, generator=gen) for _ in range(2))
    k, v = (torch.randn(b, tk, h, d, generator=gen) for _ in range(2))
    seg = None
    if segmented:
        qs = torch.randint(1, 5, (b, tq), generator=gen).sort(dim=1).values
        ks = torch.randint(1, 5, (b, tk), generator=gen).sort(dim=1).values
        qs[:, 0] = 99                      # a query whose segment has no key
        seg = (qs.cuda(), ks.cuda())
    glse = (torch.randn(b, h, tq, generator=gen).cuda() if with_glse
            else None)
    return [t.to("cuda", dtype) for t in (q, k, v, do)], seg, causal, glse


def flash_mags(torch, fl, q, k, v, do, lse, delta, glse, causal, seg):
    """Per output element of dQ, dK, dV: the sum of the magnitudes of the
    products that make it (the yardstick of the backward tolerances)."""
    p, _ = fl._p_ds(q, k, v, do, lse, delta, None, causal,
                    q.shape[-1] ** -0.5, seg)
    dpm = torch.einsum("bqhd,bkhd->bhqk", do.float().abs(), v.float().abs())
    extra = delta.abs() + (glse.abs() if glse is not None else 0)
    dsm = p * (dpm + extra[..., None]) * q.shape[-1] ** -0.5
    del dpm
    return (torch.einsum("bhqk,bkhd->bqhd", dsm, k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", dsm, q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()))


def check_flash(torch, fl, case, dtype, seed) -> dict:
    """:func:`check_flash_on` the inputs of one of FLASH_CASES."""
    (q, k, v, do), seg, causal, glse = flash_inputs(torch, case, dtype, seed)
    return check_flash_on(torch, fl, (q, k, v, do), seg, causal, glse,
                          f"flash {dtype} {case}", expect_dead=bool(seg))


def check_flash_on(torch, fl, inputs, seg, causal, glse, tag,
                   expect_dead=False) -> dict:
    """The three flash kernels against their plain versions on one case.
    Forward: out within 1e-5 of max |v| (float32 sums of p.v in another
    order); in bf16 plus one ulp of the output and 2^-8 max |v| (p is
    rounded to bf16 on both sides from float32 values that may round
    apart); lse within 1e-5 (1 + |lse|) and exactly -1e30 with a zero
    output on rows that see no key. Backward (from the plain lse):
    within 1e-5 of the sum of the products' magnitudes, in bf16 plus one
    ulp and 2^-8 of that sum. In bf16 also against the truth, the plain
    versions run on float32 copies of the same bf16 inputs: the kernels'
    largest errors in the forward output, dQ, dK and dV are at most twice
    the plain bf16 versions' (plus 1e-5 of max |v| or of the products'
    magnitudes, the float32 allowance for sums in another order, which
    only counts where both errors are that small). ``expect_dead``: the
    segments leave a query with no key. Returns, per kernel, the max abs
    error, the largest error over its tolerance, the largest |plain
    output| (so that an error of 0 is seen to be over values that are
    not) and, in bf16, both errors against the truth."""
    q, k, v, do = inputs
    dtype = q.dtype
    out, lse = fl.flash_attention_forward(q, k, v, causal=causal,
                                          segment_ids=seg, with_lse=True)
    pout, plse = fl.flash_attention_forward_reference(q, k, v, causal=causal,
                                                      segment_ids=seg)
    vmax = v.float().abs().max()
    bf = dtype == torch.bfloat16
    tol = 1e-5 * vmax + ((bf16_ulp(torch, pout.float()) + 2.0**-8 * vmax)
                         if bf else 0)
    ok, err_f, ratio_f = within(torch, out, pout, tol)
    check(ok, f"{tag}: forward error {err_f} is {ratio_f:.3g}x its tolerance")
    ok, err_l, ratio = within(torch, lse, plse, 1e-5 * (1 + plse.abs()))
    check(ok, f"{tag}: lse error {err_l} is {ratio:.3g}x its tolerance")
    fwd = "flash_attention_forward"
    errs = {fwd: max(err_f, err_l)}
    ratios = {fwd: max(ratio_f, ratio)}
    refs = {fwd: pout.float().abs().max().item()}
    truth = {}
    if bf:
        f32 = [t.float() for t in (q, k, v, do)]
        tout, tlse = fl.flash_attention_forward_reference(
            *f32[:3], causal=causal, segment_ids=seg)
        truth[fwd] = (out, pout, tout, 1e-5 * vmax)
    dead = plse <= -1e30
    check(bool((lse[dead] == plse[dead]).all())
          and bool((out.float().transpose(1, 2)[dead] == 0).all()),
          f"{tag}: rows with no key are not 0 with lse -1e30")
    check(not expect_dead or bool(dead.any()), f"{tag}: no row without a "
          "key")
    delta = (pout.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    del out, pout
    kw = dict(causal=causal, segment_ids=seg, glse=glse)
    got = (fl.flash_attention_dq(q, k, v, do, plse, delta, **kw),
           *fl.flash_attention_dkv(q, k, v, do, plse, delta, **kw))
    want = (fl.flash_attention_dq_reference(q, k, v, do, plse, delta, **kw),
            *fl.flash_attention_dkv_reference(q, k, v, do, plse, delta, **kw))
    mags = flash_mags(torch, fl, q, k, v, do, plse, delta, glse, causal, seg)
    for name, g, w, m in zip(("dq", "dk", "dv"), got, want, mags):
        tol = 1e-5 * m + ((bf16_ulp(torch, w.float()) + 2.0**-8 * m)
                          if bf else 0)
        ok, err, ratio = within(torch, g, w, tol)
        check(ok, f"{tag}: {name} error {err} is {ratio:.3g}x its tolerance")
        key = "flash_attention_dq" if name == "dq" else "flash_attention_dkv"
        errs[key] = max(errs.get(key, 0.0), err)
        ratios[key] = max(ratios.get(key, 0.0), ratio)
        refs[key] = max(refs.get(key, 0.0), w.float().abs().max().item())
    if bf:
        tdelta = (tout * f32[3]).sum(-1).transpose(1, 2).contiguous()
        tkw = dict(causal=causal, segment_ids=seg, glse=glse)
        tdq = fl.flash_attention_dq_reference(*f32, tlse, tdelta, **tkw)
        tdk, tdv = fl.flash_attention_dkv_reference(*f32, tlse, tdelta, **tkw)
        truth["dq"] = (got[0], want[0], tdq, 1e-5 * mags[0].max())
        truth["dk"] = (got[1], want[1], tdk, 1e-5 * mags[1].max())
        truth["dv"] = (got[2], want[2], tdv, 1e-5 * mags[2].max())
    f32_truth = {}
    for name, (kern, plain, true, floor) in truth.items():
        e_k = (kern.float() - true).abs().max().item()
        e_p = (plain.float() - true).abs().max().item()
        f32_truth[name] = {"kernel": e_k, "plain_bf16": e_p,
                           "within_2x": e_k <= 2 * e_p}
        check(e_k <= 2 * e_p + float(floor),
              f"{tag}: {name} is {e_k} from the float32 truth, more than "
              f"twice the plain bf16 version's {e_p}")
    torch.cuda.synchronize()
    return {"max_abs_err": errs, "max_err_over_tol": ratios,
            "max_abs_plain": refs, "f32_truth": f32_truth}


def flash_bounds(b, t, h, d, elem, kind, pairs=None) -> dict:
    """Least time of one flash call: its inputs read once and outputs
    written once over the memory rate, or its products at the bf16
    tensor-core rate, whichever is longer. Forward (with lse): q, k, v
    read, o and lse written, QKᵀ and PV. dQ: q, k, v, dO, lse, delta
    read, dq written, QKᵀ, dO.Vᵀ and dS.K. dK/dV: the same reads, dk and
    dv written, and one more product. ``pairs``: the (query, key) pairs
    per head that the mask keeps, summed over the batch (b * t * t when
    nothing is masked); a product costs 2 * d * pairs a head."""
    x = b * t * h * d * elem
    row = b * h * t * 4
    pairs = b * t * t if pairs is None else pairs
    product = 2 * h * pairs * d
    nbytes, flops = {"forward": (4 * x + row, 2 * product),
                     "dq": (5 * x + 2 * row, 3 * product),
                     "dkv": (6 * x + 2 * row, 4 * product)}[kind]
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / BF16_FLOP_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms)}


def phase_flash_kernels(torch) -> dict:
    """Every flash case in f32 and bf16, then the times at batch 128 in
    bf16 (the training main path's inputs), cold L2. Returns {kernel
    name: [per-layer row]} for the kernel line."""
    import torch.nn.functional as F

    from tpunet_torch.ops import flash as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    worst = {}
    for i, case in enumerate(FLASH_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            res = check_flash(torch, fl, case, dtype, SEED + 200 + i)
            for k, e in res["max_abs_err"].items():
                worst[k] = max(worst.get(k, 0.0), e)
            emit("kernel_vs_plain", name="flash_attention", case=list(case),
                 dtype=str(dtype), **res)
            torch.cuda.empty_cache()

    def timed(b):
        gen = torch.Generator().manual_seed(SEED + 300 + b)
        qkv = torch.randn(b, 196, 3, 12, 64, generator=gen).cuda().bfloat16()
        do = torch.randn(b, 196, 12, 64, generator=gen).cuda().bfloat16()
        return (*qkv.unbind(2), do)

    # Serving: batch 8, the forward without lse (emitted, not in the line).
    q, k, v, _ = timed(BATCH)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    emit("flash_serving_forward", batch=BATCH, **flash_bounds(
        BATCH, 196, 12, 64, 2, "forward"),
         kernel_ms=time_ms(torch, lambda: fl.flash_attention_forward(q, k, v)),
         plain_ms=time_ms(torch, lambda: fl.flash_attention_forward_reference(
             q, k, v), reps=10),
         library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
             qh, kh, vh)))

    q, k, v, do = timed(TRAIN_BATCH)
    out, lse = fl.flash_attention_forward(q, k, v, with_lse=True)
    delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    lib = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib)
    lib_do = do.transpose(1, 2)

    def lib_bwd():
        torch.autograd.grad(lib_out, lib, lib_do, retain_graph=True)

    bwd_lib_ms = time_ms(torch, lib_bwd, reps=20)
    rows = {
        "flash_attention_forward": dict(
            kernel_ms=time_ms(torch, lambda: fl.flash_attention_forward(
                q, k, v, with_lse=True), reps=20),
            plain_ms=time_ms(torch, lambda: fl.flash_attention_forward_reference(
                q, k, v), reps=5, warmup=2),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                *lib), reps=20),
            **flash_bounds(TRAIN_BATCH, 196, 12, 64, 2, "forward")),
        "flash_attention_dq": dict(
            kernel_ms=time_ms(torch, lambda: fl.flash_attention_dq(
                q, k, v, do, lse, delta), reps=20),
            plain_ms=time_ms(torch, lambda: fl.flash_attention_dq_reference(
                q, k, v, do, lse, delta), reps=5, warmup=2),
            library_ms=bwd_lib_ms,
            **flash_bounds(TRAIN_BATCH, 196, 12, 64, 2, "dq")),
        "flash_attention_dkv": dict(
            kernel_ms=time_ms(torch, lambda: fl.flash_attention_dkv(
                q, k, v, do, lse, delta), reps=20),
            plain_ms=time_ms(torch, lambda: fl.flash_attention_dkv_reference(
                q, k, v, do, lse, delta), reps=5, warmup=2),
            library_ms=bwd_lib_ms,
            **flash_bounds(TRAIN_BATCH, 196, 12, 64, 2, "dkv")),
    }
    for name, row in rows.items():
        # Shares of the memory and bf16 tensor-core rates that the kernel
        # reaches: what is left is neither bytes nor products.
        row.update(hbm_share=row["bytes_ms"] / row["kernel_ms"],
                   tensor_share=row["ops_ms"] / row["kernel_ms"])
        row.update(batch=TRAIN_BATCH, layers=VIT_LAYERS,
                   design=FLASH_DESIGN[name], max_abs_err=worst[name],
                   bound_by="bytes" if row["bytes_ms"] >= row["ops_ms"]
                   else "operations")
        emit("flash_timing", name=name, **row)
    del lib, lib_out
    torch.cuda.empty_cache()
    return {name: [row] for name, row in rows.items()}


def vit_state(torch):
    """ViT-B/16 weights from a seed, with the zero-initialised classifier
    drawn at random (a zero head makes every logit 0 and every gradient
    above it 0, and any comparison would pass)."""
    from tpunet_torch.config import ModelConfig
    from tpunet_torch.models import create_model

    gen = torch.Generator().manual_seed(SEED + 400)
    model = create_model(ModelConfig(name="vit_base", dtype="float32"),
                         device="cpu", generator=gen)
    with torch.no_grad():
        model.classifier.weight.normal_(0.0, 0.05, generator=gen)
        model.classifier.bias.normal_(0.0, 0.1, generator=gen)
    return model.state_dict()


def phase_vit_serving(torch, state):
    """ViT-B/16 classify serving: the same clients, images and window as
    the MobileNetV2 window, 12 flash launches a batched forward, and the
    batched logits with the kernel against the plain versions."""
    import numpy as np

    from tpunet_torch.config import DataConfig, ModelConfig, ServeConfig
    from tpunet_torch.infer.predict import Predictor, preprocess
    from tpunet_torch.ops import flash as fl
    from tpunet_torch.serve import ClassifyBatcher

    data, serve = DataConfig(), ServeConfig()
    pred = Predictor(ModelConfig(name="vit_base"), data, state_dict=state,
                     device="cuda")
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (*REQUEST_SIZES[i % 3], 3), np.uint8)
              for i in range(N_IMAGES)]

    def batcher():
        return ClassifyBatcher(pred, batch_max=serve.classify_batch_max,
                               window_ms=serve.classify_window_ms)

    warm = batcher()
    try:
        for img in images[:3]:
            warm.submit(img, timeout=120.0)
    finally:
        warm.close()
    torch.cuda.synchronize()
    served = batcher()
    reset_launch_counts()
    try:
        wall, answers, errors = serve_window(served, images)
    finally:
        served.close()
    launches = launch_counts()
    snap = served.registry.snapshot()
    check(not errors, f"ViT requests failed: {errors[:3]}")
    n = len(answers)
    batches = snap.get("serve_classify_batches_total", 0)
    check(n >= 16 and snap.get("serve_classify_requests_total") == n,
          f"ViT: {n} answers, {snap.get('serve_classify_requests_total')} "
          "requests counted")
    probs = np.stack([p for _, _, p in answers])
    check(probs.shape == (n, 10) and bool(np.isfinite(probs).all())
          and bool(np.all(np.abs(probs.sum(1) - 1.0) <= 1e-4)),
          f"ViT probabilities {probs.shape} not finite rows summing to 1")
    fwd = launches["flash_attention_forward"]
    check(fwd == VIT_LAYERS * batches and launches["flash_attention_dq"] == 0
          and launches["flash_attention_dkv"] == 0,
          f"ViT serving: {launches} for {batches} batched forwards (want "
          f"{VIT_LAYERS} forward launches each, no backward)")
    lat_ms = np.array([s for _, s, _ in answers]) * 1e3
    emit("vit_serving", requests=n, clients=N_CLIENTS, window_s=WINDOW_S,
         wall_s=wall, batches=batches, mean_batch=n / batches,
         flash_launches=fwd, flash_launches_per_forward=fwd / batches,
         requests_per_s=n / wall,
         latency_p50_ms=float(np.percentile(lat_ms, 50)),
         latency_p99_ms=float(np.percentile(lat_ms, 99)),
         latency_max_ms=float(lat_ms.max()),
         batch_s_p50_ms=snap["serve_classify_s_p50"] * 1e3,
         batch_s_p99_ms=snap["serve_classify_s_p99"] * 1e3)

    # One batch through the kernels and through the plain versions on the
    # card: the same arithmetic up to the order of float32 sums and the
    # bf16 roundings of p, so the tolerance is 2 bf16 ulps of the largest
    # logit.
    x = torch.stack([preprocess(images[i], data, "cuda")
                     for i in range(BATCH)]).permute(0, 3, 1, 2)
    with torch.inference_mode():
        kern = pred.model(x)
        with plain_versions():
            plain = pred.model(x)
        wall_ms = [loop_us(torch, lambda: pred.model(x), n=20) / 1e3
                   for _ in range(2)]
    torch.cuda.synchronize()
    diff = (kern - plain).abs().max().item()
    tol = 2 * 2.0**-7 * plain.abs().max().item()
    check(bool(torch.isfinite(kern).all()) and plain.abs().max().item() > 0,
          "ViT logits non-finite or all zero")
    check(diff <= tol, f"ViT batched logits kernel vs plain: {diff} > {tol}")
    emit("vit_serving_checks", logits_kernel_vs_plain_max_abs=diff,
         tolerance=tol, forward_wall_ms_batch8=wall_ms)
    del pred
    torch.cuda.empty_cache()
    return fwd / batches


def phase_vit_train(torch, state):
    """ViT-B/16 training at batch 128: the f32 whole-step check, then the
    bf16 main path; returns (launch counts, images/s)."""
    import numpy as np

    from tpunet_torch.config import DataConfig, ModelConfig, OptimConfig
    from tpunet_torch.data import synthetic_cifar10
    from tpunet_torch.data.augment import make_train_augment
    from tpunet_torch.models import create_model
    from tpunet_torch.ops.attention import dense_attention
    from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
    from tpunet_torch.train.steps import make_train_step
    from tpunet_torch.utils.prng import step_generator

    data, optim = DataConfig(dataset="synthetic"), OptimConfig()
    images, labels = synthetic_cifar10(n_train=TRAIN_BATCH, n_test=1)[:2]
    xb = torch.from_numpy(images).cuda()
    yb = torch.from_numpy(labels.astype(np.int64)).cuda()
    augment = make_train_augment(data)

    def make(dtype):
        model = create_model(ModelConfig(name="vit_base", dtype=dtype),
                             device="cuda")
        model.load_state_dict(state)
        return model

    # One float32 step (dropout 0.2 from the same step generator on every
    # path), matrix products in full float32 (TF32 off; the patch
    # embedding is a matmul, not a cuDNN convolution): the loss within
    # 1e-5 and every gradient within 1e-4 in relative L2 norm of the
    # plain versions'. The ViT has no BatchNorm, so float32 gradients are
    # well conditioned; the dense attention path is printed beside as a
    # yardstick.
    torch.backends.cuda.matmul.allow_tf32 = False
    model = make("float32")
    grad_step(torch, model, augment, xb, yb, 7)                 # warm-up
    k_loss, k_grads, _ = grad_step(torch, model, augment, xb, yb, 7)
    with plain_versions():
        p_loss, p_grads, _ = grad_step(torch, model, augment, xb, yb, 7)
    model.attn_fn = dense_attention
    d_loss, d_grads, _ = grad_step(torch, model, augment, xb, yb, 7)
    del model
    torch.cuda.empty_cache()

    def rel(got, want):
        return {k: ((got[k] - want[k]).norm()
                    / want[k].norm().clamp_min(1e-30)).item() for k in want}

    g_err, g_dense = rel(k_grads, p_grads), rel(d_grads, p_grads)
    worst = sorted(g_err, key=g_err.get, reverse=True)
    f32 = dict(loss_kernel=k_loss, loss_plain=p_loss, loss_dense=d_loss,
               loss_rel_err=abs(k_loss - p_loss) / abs(p_loss),
               grad_err_worst={k: g_err[k] for k in worst[:4]},
               grad_err_median=statistics.median(g_err.values()),
               grad_err_max=g_err[worst[0]],
               dense_grad_err_median=statistics.median(g_dense.values()),
               dense_grad_err_max=max(g_dense.values()),
               zero_grads=[k for k, g in p_grads.items()
                           if g.abs().max().item() == 0])
    emit("vit_train_grad_check_f32", **f32)
    del k_grads, p_grads, d_grads
    check(math.isfinite(k_loss) and f32["loss_rel_err"] <= 1e-5,
          f"ViT f32 train loss kernel {k_loss} vs plain {p_loss}")
    check(not f32["zero_grads"], f"ViT zero gradients: {f32['zero_grads']}")
    check(f32["grad_err_max"] <= 1e-4, f"ViT f32 gradient {worst[0]}: "
          f"relative L2 error {f32['grad_err_max']:.3g} > 1e-4")

    # The bf16 main path: the train step as the trainer calls it, on one
    # repeated batch, with every launch count at 0 before it.
    model = make("bfloat16")
    state_fn = TrainState(model, make_optimizer(model.parameters(), optim),
                          lr_schedule(optim, 1, 20))
    step_fn = make_train_step(data, optim)
    step_fn(state_fn, xb, yb, step_generator(42, 10_000))     # warm-up
    torch.cuda.synchronize()
    model.load_state_dict(state)
    state_fn = TrainState(model, make_optimizer(model.parameters(), optim),
                          lr_schedule(optim, 1, 20))
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step_fn(state_fn, xb, yb, step_generator(42, state_fn.global_step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss_sum"]) / TRAIN_BATCH)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in ("flash_attention_forward", "flash_attention_dq",
                 "flash_attention_dkv"):
        check(launches[name] == VIT_LAYERS * TRAIN_STEPS,
              f"ViT {name}: {launches[name]} launches in {TRAIN_STEPS} "
              f"steps (want {VIT_LAYERS} a step)")
    check(all(math.isfinite(v) for v in losses), f"ViT non-finite loss: "
          f"{losses}")
    steady = sorted(times[2:])
    p50 = statistics.median(steady)
    emit("vit_train_main_path", model="vit_base", image_size=224,
         batch=TRAIN_BATCH, steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         step_ms_p50=p50 * 1e3, step_ms_min=steady[0] * 1e3,
         step_ms_max=steady[-1] * 1e3, images_per_s=TRAIN_BATCH / p50,
         peak_memory_bytes=peak)
    prof = profile_step(torch, lambda: step_fn(
        state_fn, xb, yb, step_generator(42, state_fn.global_step)),
        p50 * 1e3, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    emit("vit_train_step_profile", **prof)
    del model, state_fn
    torch.cuda.empty_cache()
    return launches, TRAIN_BATCH / p50


# ---------------------------------------------------------------------------
# The LM (--model lm) at ViT-B/16's widths
# ---------------------------------------------------------------------------

LM_BATCH = 16        # sequences a training step: 16,384 tokens
LM_T = 1024          # --seq-len and --max-seq-len
LM_VOCAB = 256       # byte-level, the text_lm vocabulary
LM_LAYERS = 12       # one flash call per layer and direction
LM_HIDDEN, LM_HEADS = 768, 12                  # head dim 64
LM_PACKED_STEPS = 5
# bf16 decode logits against the flash forward's, as a share of the
# largest logit: the decode attend keeps p in float32, the kernel rounds
# it to bf16 before p.V (measured on the H100: 0.0108, argmax agreement
# 0.988; the gate leaves a factor of 2.9).
LM_DECODE_BF16_TOL = 2.0**-5
LM_GEN_BATCH, LM_PROMPT, LM_NEW = 8, 128, 256
LM_FLAGS = ("--model", "lm", "--vit-hidden", str(LM_HIDDEN), "--vit-depth",
            str(LM_LAYERS), "--vit-heads", str(LM_HEADS), "--seq-len",
            str(LM_T), "--max-seq-len", str(LM_T), "--vocab-size",
            str(LM_VOCAB))
LM_DIR = ROOT / "build" / "tpunet_torch"
# The corpus of the packed phases: the repo's own Markdown, one document
# a non-empty line.
LM_CORPUS_SOURCES = ("README.md", "SURVEY.md", "docs/*.md")


def lm_config(dtype="bfloat16", dropout_rate=0.2):
    from tpunet_torch.config import ModelConfig
    return ModelConfig(name="lm", vit_hidden=LM_HIDDEN, vit_depth=LM_LAYERS,
                       vit_heads=LM_HEADS, vocab_size=LM_VOCAB,
                       max_seq_len=LM_T,
                       dtype=dtype, dropout_rate=dropout_rate)


def lm_corpus() -> Path:
    """Concatenate the corpus into build/ (nothing is downloaded)."""
    path = LM_DIR / "lm_corpus" / "corpus.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    files = [f for pat in LM_CORPUS_SOURCES for f in sorted(ROOT.glob(pat))]
    path.write_bytes(b"".join(f.read_bytes() for f in files))
    return path


def lm_batches(torch):
    """(tokens [16,1024] of synthetic_lm, (tokens, segment ids) of the
    packed corpus's first 16 rows), int32 on the card."""
    from tpunet_torch.data.lm import synthetic_lm, text_lm_packed

    toks = synthetic_lm(LM_BATCH, 1, seq_len=LM_T, vocab=LM_VOCAB)[0]
    px, py = text_lm_packed(str(lm_corpus()), LM_T)[:2]
    check(len(px) >= LM_BATCH, f"the corpus packs into {len(px)} rows")
    return (torch.from_numpy(toks).cuda(),
            (torch.from_numpy(px[:LM_BATCH]).cuda(),
             torch.from_numpy(py[:LM_BATCH]).cuda()))


def attended_pairs(torch, segs) -> int:
    """(query, key) pairs that causality and the segments keep, summed
    over the rows: a run of n tokens of one id keeps n (n + 1) / 2 (the
    padding tail of id 0 included: the kernels compute it)."""
    n = torch.cat([torch.bincount(r.long()) for r in segs.cpu()])
    return int((n * (n + 1) // 2).sum())


def phase_lm_kernels(torch) -> dict:
    """The three flash kernels at the LM's shapes (B 16, T 1024, 12 x 64,
    causal; then the packed corpus's first 16 rows as segments) against
    their plain versions in f32 and bf16 (bf16 also against the float32
    truth), then timed in bf16, cold L2, against their bound, their plain
    versions and SDPA (``is_causal=True``; a boolean mask for the packed
    rows; its backward through autograd). Returns {kernel: {shape: row}}."""
    import torch.nn.functional as F

    from tpunet_torch.ops import flash as fl

    torch.backends.cuda.matmul.allow_tf32 = False
    _, (_, segs) = lm_batches(torch)
    shapes = {"causal": None, "packed": (segs.int(), segs.int())}
    hd = LM_HIDDEN // LM_HEADS
    worst = {}

    def inputs(dtype, seed):
        gen = torch.Generator().manual_seed(seed)
        qkv = torch.randn(LM_BATCH, LM_T, 3, LM_HEADS, hd, generator=gen)
        do = torch.randn(LM_BATCH, LM_T, LM_HEADS, hd, generator=gen)
        return (*qkv.to("cuda", dtype).unbind(2), do.to("cuda", dtype))

    for i, (shape, seg) in enumerate(shapes.items()):
        for dtype in (torch.float32, torch.bfloat16):
            res = check_flash_on(torch, fl, inputs(dtype, SEED + 500 + i),
                                 seg, True, None, f"LM flash {shape} {dtype}")
            for k, e in res["max_abs_err"].items():
                worst[k] = max(worst.get(k, 0.0), e)
            emit("lm_kernel_vs_plain", name="flash_attention", shape=shape,
                 case=[LM_BATCH, LM_T, LM_HEADS, hd], dtype=str(dtype), **res)
            torch.cuda.empty_cache()

    rows = {name: {} for name in ("flash_attention_forward",
                                  "flash_attention_dq", "flash_attention_dkv")}
    for i, (shape, seg) in enumerate(shapes.items()):
        q, k, v, do = inputs(torch.bfloat16, SEED + 510 + i)
        out, lse = fl.flash_attention_forward(q, k, v, causal=True,
                                              segment_ids=seg, with_lse=True)
        delta = (out.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(causal=True, segment_ids=seg)
        lib = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        if seg is None:
            pairs = LM_BATCH * LM_T * (LM_T + 1) // 2
            sdpa = dict(is_causal=True)
        else:
            pairs = attended_pairs(torch, seg[0])
            pos = torch.arange(LM_T, device="cuda")
            mask = ((pos[:, None] >= pos[None, :])
                    & (seg[0][:, :, None] == seg[0][:, None, :]))[:, None]
            sdpa = dict(attn_mask=mask)
        lib_out = F.scaled_dot_product_attention(*lib, **sdpa)
        lib_do = do.transpose(1, 2)

        def lib_bwd():
            torch.autograd.grad(lib_out, lib, lib_do, retain_graph=True)

        bwd_lib_ms = time_ms(torch, lib_bwd, reps=20)
        timed = {
            "flash_attention_forward": (
                lambda: fl.flash_attention_forward(q, k, v, with_lse=True,
                                                   **kw),
                lambda: fl.flash_attention_forward_reference(q, k, v, **kw),
                time_ms(torch, lambda: F.scaled_dot_product_attention(
                    *lib, **sdpa), reps=20), "forward"),
            "flash_attention_dq": (
                lambda: fl.flash_attention_dq(q, k, v, do, lse, delta, **kw),
                lambda: fl.flash_attention_dq_reference(q, k, v, do, lse,
                                                        delta, **kw),
                bwd_lib_ms, "dq"),
            "flash_attention_dkv": (
                lambda: fl.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
                lambda: fl.flash_attention_dkv_reference(q, k, v, do, lse,
                                                         delta, **kw),
                bwd_lib_ms, "dkv")}
        for name, (kern, plain, lib_ms, kind) in timed.items():
            row = dict(kernel_ms=time_ms(torch, kern, reps=20),
                       plain_ms=time_ms(torch, plain, reps=3, warmup=1),
                       library_ms=lib_ms, pairs=pairs,
                       **flash_bounds(LM_BATCH, LM_T, LM_HEADS, hd, 2, kind,
                                      pairs))
            row.update(hbm_share=row["bytes_ms"] / row["kernel_ms"],
                       tensor_share=row["ops_ms"] / row["kernel_ms"],
                       bound_by="bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations", layers=LM_LAYERS,
                       max_abs_err=worst[name])
            rows[name][shape] = row
            emit("lm_flash_timing", name=name, shape=shape, batch=LM_BATCH,
                 t=LM_T, **row)
        del lib, lib_out, q, k, v, do, out, lse, delta
        torch.cuda.empty_cache()
    return rows


def lm_grads(torch, model, tokens, segs=None):
    """Loss and parameter gradients of one LM forward/backward (the
    train step's loss, no update) from a fixed generator."""
    from tpunet_torch.train.steps import _next_token, _packed_target_weights

    model.zero_grad(set_to_none=True)
    ce, _ = _next_token(model, tokens, segs, 0.0, train=True,
                        generator=torch.Generator().manual_seed(7))
    if segs is None:
        loss = ce.mean()
    else:
        wt = _packed_target_weights(segs)
        loss = (ce * wt).sum() / wt.sum()
    loss.backward()
    torch.cuda.synchronize()
    return loss.item(), {k: p.grad.detach().float().clone()
                         for k, p in model.named_parameters()}


def phase_lm_train(torch) -> dict:
    """The LM's training main path: one f32 step with the kernels against
    the plain versions; 30 bf16 steps on synthetic_lm with the launch
    counts, step time, tokens/s, peak memory and a profiled step; 5
    packed steps on the corpus. Returns the launch counts a step."""
    from tpunet_torch.config import OptimConfig
    from tpunet_torch.models import create_model
    from tpunet_torch.train.state import TrainState, lr_schedule, make_optimizer
    from tpunet_torch.train.steps import make_lm_train_step
    from tpunet_torch.utils.prng import step_generator

    tokens, (ptok, psegs) = lm_batches(torch)
    gen = torch.Generator().manual_seed(SEED + 600)
    state = create_model(lm_config("float32", 0.0), device="cpu",
                         generator=gen).state_dict()

    # One float32 step at dropout 0, TF32 off: the loss within 1e-5
    # relative and every gradient within 1e-4 of the largest gradient of
    # the plain versions' step (ViT's gate); packed rows the same.
    torch.backends.cuda.matmul.allow_tf32 = False
    model = create_model(lm_config("float32", 0.0), device="cuda")
    model.load_state_dict(state)
    f32 = {}
    for shape, (x, s) in (("causal", (tokens, None)),
                          ("packed", (ptok, psegs))):
        lm_grads(torch, model, x, s)                       # warm-up
        k_loss, k_grads = lm_grads(torch, model, x, s)
        with plain_versions():
            p_loss, p_grads = lm_grads(torch, model, x, s)
        gmax = max(g.abs().max().item() for g in p_grads.values())
        err = {k: (k_grads[k] - p_grads[k]).abs().max().item() / gmax
               for k in p_grads}
        rel = {k: ((k_grads[k] - p_grads[k]).norm()
                   / p_grads[k].norm().clamp_min(1e-30)).item()
               for k in p_grads}
        worst = max(err, key=err.get)
        f32[shape] = dict(loss_kernel=k_loss, loss_plain=p_loss,
                          loss_rel_err=abs(k_loss - p_loss) / abs(p_loss),
                          grad_err_of_largest_max=err[worst],
                          grad_err_worst=worst, grad_max=gmax,
                          grad_rel_l2_median=statistics.median(rel.values()),
                          grad_rel_l2_max=max(rel.values()))
        check(math.isfinite(k_loss) and f32[shape]["loss_rel_err"] <= 1e-5,
              f"LM f32 {shape} loss kernel {k_loss} vs plain {p_loss}")
        check(err[worst] <= 1e-4, f"LM f32 {shape} gradient {worst}: "
              f"{err[worst]:.3g} of the largest gradient > 1e-4")
        del k_grads, p_grads
    emit("lm_train_grad_check_f32", **f32)
    del model
    torch.cuda.empty_cache()

    optim = OptimConfig()
    model = create_model(lm_config(), device="cuda")
    model.load_state_dict(state)

    def fresh(packed=False):
        model.load_state_dict(state)
        return (TrainState(model, make_optimizer(model.parameters(), optim),
                           lr_schedule(optim, 1, 20)),
                make_lm_train_step(optim, packed))

    st, step_fn = fresh()
    step_fn(st, tokens, tokens, step_generator(42, 10_000))   # warm-up
    torch.cuda.synchronize()
    st, step_fn = fresh()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        m = step_fn(st, tokens, tokens, step_generator(42, st.global_step))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss_sum"]) / float(m["count"]))
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    flash_names = ("flash_attention_forward", "flash_attention_dq",
                   "flash_attention_dkv")
    for name in flash_names:
        check(launches[name] == LM_LAYERS * TRAIN_STEPS,
              f"LM {name}: {launches[name]} launches in {TRAIN_STEPS} steps "
              f"(want {LM_LAYERS} a step)")
    check(all(math.isfinite(v) for v in losses), f"LM non-finite loss: "
          f"{losses}")
    check(losses[-1] < losses[0], f"LM loss did not fall over {TRAIN_STEPS} "
          f"steps: {losses[0]} -> {losses[-1]}")
    steady = sorted(times[2:])
    p50 = statistics.median(steady)
    emit("lm_train_main_path", batch=LM_BATCH, seq_len=LM_T,
         steps=TRAIN_STEPS, launches=launches,
         launches_per_step={k: v / TRAIN_STEPS for k, v in launches.items()},
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         step_ms_p50=p50 * 1e3, step_ms_min=steady[0] * 1e3,
         step_ms_max=steady[-1] * 1e3,
         tokens_per_s=LM_BATCH * LM_T / p50, peak_memory_bytes=peak)
    prof = profile_step(torch, lambda: step_fn(
        st, tokens, tokens, step_generator(42, st.global_step)), p50 * 1e3,
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    emit("lm_train_step_profile", **prof)

    # Packed rows of the corpus: the same launches, a falling loss.
    st, step_fn = fresh(packed=True)
    step_fn(st, ptok, psegs, step_generator(42, 10_000))      # warm-up
    torch.cuda.synchronize()
    st, step_fn = fresh(packed=True)
    plosses, ptimes = [], []
    reset_launch_counts()
    for _ in range(LM_PACKED_STEPS):
        t0 = time.perf_counter()
        m = step_fn(st, ptok, psegs, step_generator(42, st.global_step))
        torch.cuda.synchronize()
        ptimes.append(time.perf_counter() - t0)
        plosses.append(float(m["loss_sum"]) / float(m["count"]))
    plaunches = launch_counts()
    for name in flash_names:
        check(plaunches[name] == LM_LAYERS * LM_PACKED_STEPS,
              f"LM packed {name}: {plaunches[name]} launches in "
              f"{LM_PACKED_STEPS} steps (want {LM_LAYERS} a step)")
    check(all(math.isfinite(v) for v in plosses) and plosses[-1] < plosses[0],
          f"LM packed loss not finite and falling: {plosses}")
    pmed = statistics.median(ptimes[1:])
    emit("lm_packed_train", steps=LM_PACKED_STEPS, launches=plaunches,
         losses=plosses, valid_targets=int(m["count"]),
         step_ms_median=pmed * 1e3,
         segments_per_row=float(psegs.amax(1).float().mean()))
    emit("lm_packed_step_profile", **profile_step(torch, lambda: step_fn(
        st, ptok, psegs, step_generator(42, st.global_step)), pmed * 1e3,
        ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))
    del model, st
    torch.cuda.empty_cache()
    return {k: v / TRAIN_STEPS for k, v in launches.items()}, \
        LM_BATCH * LM_T / p50


def run_cli(args, timeout=600) -> str:
    out = subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    check(out.returncode == 0, f"{' '.join(args[:3])} exited "
          f"{out.returncode}: {out.stderr[-2000:]}")
    return out.stdout


def run_cli_here(torch, args) -> tuple:
    """``python -m tpunet_torch.train`` with ``args`` in this process
    (its entry point, ``__main__.run``): (the closed Trainer, its
    stdout), so that its syncs can be counted and its gauges read."""
    import contextlib
    import io

    from tpunet_torch.train import __main__ as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        trainer = cli.run(list(args))
    return trainer, buf.getvalue()


def phase_lm_trainer(torch, sync_step_ms=None) -> None:
    """The training CLI on the LM: one synthetic_lm epoch (1,024 train
    and 256 test sequences, in this process, obs on: check_obs_epoch)
    and --eval-only of its best.pth, which must read the epoch's test
    accuracy; the same epoch with --no-obs and with a 2-step profile
    window (check_syncs, check_window); one packed text_lm epoch on the
    corpus; then the generate CLI on that run."""
    import re

    runs, obs = {}, {}
    for tag, data in (
            ("synthetic_lm", ("--dataset", "synthetic_lm",
                              "--synthetic-size", "1024")),
            ("packed_text_lm", ("--dataset", "text_lm", "--pack-docs",
                                "--text-file", str(lm_corpus())))):
        ckdir = LM_DIR / f"smoke_lm_{tag}"
        shutil.rmtree(ckdir, ignore_errors=True)
        flags = ("tpunet_torch.train", "--preset", "single", *LM_FLAGS,
                 *data, "--batch-size", str(LM_BATCH), "--checkpoint-dir",
                 str(ckdir))
        t0 = time.perf_counter()
        if tag == "synthetic_lm":
            torch.cuda.reset_peak_memory_stats()
            with SyncCounter(torch) as on_sync:
                trainer, out = run_cli_here(torch, [*flags[1:], "--epochs",
                                                    "1"])
        else:
            out = run_cli([*flags, "--epochs", "1"])
        wall = time.perf_counter() - t0
        check(re.search(r"^Epoch 1/1 Time: ", out, re.M) is not None,
              f"{tag}: no epoch line in {out[-1000:]}")
        records = read_records(ckdir)
        rec = [r for r in records if "kind" not in r][-1]
        check(all(math.isfinite(rec[k]) for k in ("train_loss", "test_loss"))
              and rec["tokens_per_sec"] > 0, f"{tag}: epoch record {rec}")
        check((ckdir / "best.pth").exists() and (ckdir / "state.pt").exists(),
              f"{tag}: files {sorted(p.name for p in ckdir.iterdir())}")
        found = None
        if tag == "synthetic_lm":
            obs = check_obs_epoch(torch, "lm_trainer", trainer, records)
            del trainer
            summary = summarize_run(records)
            out = run_cli([*flags, "--eval-only"])
            found = re.search(r"Eval: Test Loss: (\S+) Test Acc: (\S+)", out)
            check(found is not None and abs(float(found.group(2))
                                            - rec["test_accuracy"]) < 5e-5,
                  f"--eval-only read {found and found.group(0)}, the epoch "
                  f"{rec['test_accuracy']}")
            per_sec = {"obs_on": rec["tokens_per_sec"]}
            counters = {}
            for variant, extra in (("no_obs", ("--no-obs",)),
                                   ("window", OBS_WINDOW)):
                vdir = ckdir.with_name(ckdir.name + "_" + variant)
                shutil.rmtree(vdir, ignore_errors=True)
                torch.cuda.reset_peak_memory_stats()
                with SyncCounter(torch) as counters[variant]:
                    vt, _ = run_cli_here(torch, [
                        *flags[1:-1], str(vdir), "--epochs", "1", *extra])
                vrec = read_records(vdir)
                per_sec[variant] = vrec[0]["tokens_per_sec"]
                if variant == "no_obs":
                    check(len(vrec) == 1 and "kind" not in vrec[0],
                          f"lm_trainer: the --no-obs run wrote {vrec}")
                else:
                    win_obs = check_obs_epoch(torch, "lm_trainer window", vt,
                                              vrec)
                    window = check_window("lm_trainer", vdir,
                                          FLASH_WINDOW_KERNELS)
                del vt
            syncs = check_syncs("lm_trainer", on_sync, counters["no_obs"],
                                counters["window"])
            torch.cuda.empty_cache()
            emit("lm_trainer_obs", obs_epoch=obs,
                 sync_step_ms_p50=sync_step_ms,
                 step_lap_p50_ms=obs["step_time_p50_ms"],
                 obs_epoch_per_sec={"obs_on": obs["units_per_sec"],
                                    "window": win_obs["units_per_sec"]},
                 epoch_record_per_sec=per_sec, syncs=syncs, window=window,
                 summary=summary)
        runs[tag] = dict(epoch_record=rec, wall_s=wall,
                         eval_only_line=found and found.group(0))
    text = run_cli(["tpunet_torch.infer.generate", "--checkpoint-dir",
                    str(LM_DIR / "smoke_lm_packed_text_lm"),
                    *LM_FLAGS[2:8], "--max-seq-len", str(LM_T), "--prompt",
                    "The ",
                    "--tokens", "64"])
    # Greedy bytes of a briefly trained model may be spaces: the check is
    # that the prompt came back with a continuation, whatever it is.
    check(text.startswith("The ") and len(text.rstrip("\n")) > len("The "),
          f"generate printed {text!r}")
    emit("lm_trainer", runs=runs, generated=text[:200])


def phase_lm_generate(torch) -> dict:
    """Greedy KV-cache generation at B 8 (128-token prompts from
    synthetic_lm, 256 new): decode tokens/s, no flash launch a decode
    step; bf16 teacher-forced decode logits against the no-cache forward
    (the flash forward, 12 launches) at every position; in float32 the
    cache and no-cache greedy tokens equal."""
    from tpunet_torch.data.lm import synthetic_lm
    from tpunet_torch.models import create_model
    from tpunet_torch.models.lm import generate
    from tpunet_torch.models.vit import KVCache

    prompt = torch.from_numpy(synthetic_lm(
        LM_GEN_BATCH, 1, seq_len=LM_PROMPT, vocab=LM_VOCAB, seed=3)[0]).cuda()
    gen = torch.Generator().manual_seed(SEED + 700)
    state = create_model(lm_config("float32", 0.0), device="cpu",
                         generator=gen).state_dict()
    total = LM_PROMPT + LM_NEW
    res = {}
    for dtype in ("bfloat16", "float32"):
        model = create_model(lm_config(dtype, 0.0), device="cuda")
        model.load_state_dict(state)
        with torch.inference_mode():
            generate(model, prompt[:, :8], 8)                  # warm-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            buf = generate(model, prompt, LM_NEW)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            decode_launches = launch_counts()
            check(all(v == 0 for v in decode_launches.values()),
                  f"LM decode launched {decode_launches}")
            reset_launch_counts()
            full = model(buf)[:, :total - 1]
            fwd = launch_counts()["flash_attention_forward"]
            check(fwd == LM_LAYERS, f"LM no-cache forward: {fwd} flash "
                  f"launches (want {LM_LAYERS})")
            cache = model.init_cache(LM_GEN_BATCH, total)
            steps = []
            for i in range(total - 1):
                lg, cache = model(buf[:, i:i + 1], pos_offset=i, cache=cache)
                steps.append(lg)
            dec = torch.cat(steps, 1)
            if dtype == "bfloat16":
                # One decode step (the last position again) under the
                # profiler: its kernels, device time and idle share.
                i = total - 2
                emit("lm_decode_step_profile", **profile_step(
                    torch, lambda: model(buf[:, i:i + 1], pos_offset=i,
                                         cache=KVCache(cache.k, cache.v, i)),
                    wall / (total - 1) * 1e3, ()))
        err = (dec - full).abs()
        row = dict(decode_s=wall, decode_steps=total - 1,
                   ms_per_step=wall / (total - 1) * 1e3,
                   new_tokens_per_s=LM_GEN_BATCH * LM_NEW / wall,
                   logits_max_abs_err=err.max().item(),
                   logits_max_abs=full.abs().max().item(),
                   logits_err_of_max=(err.max() / full.abs().max()).item(),
                   argmax_agreement=(dec.argmax(-1) == full.argmax(-1)
                                     ).float().mean().item(),
                   decode_flash_launches=decode_launches,
                   no_cache_forward_flash_launches=fwd)
        if dtype == "float32":
            with torch.inference_mode():
                nocache = generate(model, prompt, LM_NEW, use_cache=False)
            row["greedy_cache_equals_no_cache"] = bool(torch.equal(buf,
                                                                   nocache))
            check(row["greedy_cache_equals_no_cache"], "LM f32 greedy tokens "
                  "differ between the cache and no-cache paths")
            check(row["logits_err_of_max"] <= 1e-4, f"LM f32 decode logits "
                  f"{row['logits_err_of_max']:.3g} of the largest from the "
                  "flash forward's")
        else:
            check(row["logits_err_of_max"] <= LM_DECODE_BF16_TOL,
                  f"LM bf16 decode logits {row['logits_err_of_max']:.3g} of "
                  f"the largest from the flash forward's > "
                  f"{LM_DECODE_BF16_TOL}")
        res[dtype] = row
        del model
        torch.cuda.empty_cache()
    emit("lm_generate", batch=LM_GEN_BATCH, prompt=LM_PROMPT, new=LM_NEW,
         **res)
    return res["bfloat16"]


SERVE_REQUESTS = 48      # /v1/generate requests of the serve_engine phase
SERVE_CLIENTS = 8        # closed-loop generate clients (= the engine's slots)
SERVE_CLASSIFY_CLIENTS = 2
SERVE_NEW = 128          # new tokens a request
SERVE_PREFIX = 256       # the prefix half of the prompts share
SERVE_PROMPT = (24, 480)  # prompt lengths, inclusive
SERVE_SAMPLING = dict(temperature=0.8, top_k=40, top_p=0.95)
SERVE_PARITY_NEW = 64    # new tokens of the float32 parity runs
SERVE_PARITY_SUFFIX = 64  # their prompts: the shared prefix + 64 tokens
SERVE_DIR = LM_DIR / "smoke_serve"
SPEC_K = 4               # draft tokens a verify in serve_item5
SPEC_FIT_STEPS = 300     # fit_drafter steps of its half-width drafter
SPEC_FIT_PROMPT = 24     # the fit's prompts: the traffic's first tokens
SPEC_FIT_NEW = 64        # the teacher's greedy tokens a fit prompt
SPEC_FITTED_REQUESTS = 24  # the fitted drafter's pass: the first 24 (its
#                            low acceptance makes it the phase's slowest)
CHAOS_KILL_TOKENS = 5
STORE_SUFFIX = 5         # tokens past the page-aligned shared prefix


def http_call(base, path, body=None, timeout=300.0):
    """(status, parsed JSON body, headers) of one request; a POST when
    ``body`` is given."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data,
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def http_generate(base, body, timeout=300.0) -> dict:
    """One /v1/generate exchange, sync or streamed (``body['stream']``),
    as {status, tokens, finish_reason, s}: a stream's tokens are its token
    lines (their indices must run 0, 1, ...), its finish reason and count
    its done frame's; a stream that breaks that is status -1."""
    import urllib.request

    t0 = time.perf_counter()
    if not body.get("stream"):
        code, out, _ = http_call(base, "/v1/generate", body, timeout)
        return dict(status=code, tokens=out.get("tokens"),
                    finish_reason=out.get("finish_reason"),
                    s=time.perf_counter() - t0)
    req = urllib.request.Request(base + "/v1/generate",
                                 json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        code = r.status
        lines = [json.loads(line) for line in r if line.strip()]
    toks = [ev["token"] for ev in lines if "token" in ev]
    done = lines[-1] if lines and lines[-1].get("done") else {}
    ok = done.get("n_tokens") == len(toks) and [
        ev["i"] for ev in lines if "token" in ev] == list(range(len(toks)))
    return dict(status=code if ok else -1, tokens=toks,
                finish_reason=done.get("finish_reason"),
                s=time.perf_counter() - t0)


def serve_prompts():
    """The phase's 48 requests: prompts of 24-480 tokens cut from seeded
    synthetic_lm rows, the even ones starting with one shared 256-token
    prefix; of every 4 requests the first two greedy and the last two
    sampled (each with its own seed); every fourth streamed. Also
    returns the rows and the prefix."""
    import numpy as np

    from tpunet_torch.data.lm import synthetic_lm

    rows = synthetic_lm(SERVE_REQUESTS + 10, 1, seq_len=SERVE_PROMPT[1],
                        vocab=LM_VOCAB, seed=11)[0]
    prefix = rows[-1, :SERVE_PREFIX]
    rng = np.random.default_rng(SEED + 11)
    bodies = []
    for i in range(SERVE_REQUESTS):
        if i % 2 == 0:
            n = int(rng.integers(SERVE_PREFIX + 1, SERVE_PROMPT[1] + 1))
            toks = np.concatenate([prefix, rows[i, :n - SERVE_PREFIX]])
        else:
            n = int(rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
            toks = rows[i, :n]
        body = {"tokens": toks.tolist(), "max_new_tokens": SERVE_NEW,
                "stream": i % 4 == 3}
        if i % 4 >= 2:
            body.update(SERVE_SAMPLING, seed=1000 + i)
        bodies.append(body)
    return bodies, rows, prefix


def serve_traffic(base, bodies, images, names):
    """SERVE_CLIENTS closed-loop clients send ``bodies`` (client k the
    k-th, (k+8)-th, ...), while SERVE_CLASSIFY_CLIENTS clients cycle
    ``images`` (when given) through /v1/classify until the generate
    clients are done.
    Returns (generate wall s, generate answers by request, classify
    answers as (image index, latency s, probs in ``names`` order),
    classify wall s, errors)."""
    import base64

    import numpy as np

    gen = [None] * len(bodies)
    cls = [[] for _ in range(SERVE_CLASSIFY_CLIENTS)]
    errors = []
    done = threading.Event()

    def generate_client(k):
        try:
            for i in range(k, len(bodies), SERVE_CLIENTS):
                gen[i] = http_generate(base, bodies[i])
        except (OSError, ValueError) as e:
            errors.append(f"generate client {k}: {type(e).__name__}: {e}")

    def classify_client(k):
        i = k
        try:
            while not done.is_set():
                img = images[i % len(images)]
                t = time.perf_counter()
                code, out, _ = http_call(base, "/v1/classify", {
                    "image_b64": base64.b64encode(img.tobytes()).decode(),
                    "shape": list(img.shape), "topk": 3})
                if code != 200:
                    errors.append(f"classify {i}: {code} {out}")
                    return
                cls[k].append((i % len(images), time.perf_counter() - t,
                               np.array([out["probs"][n] for n in names])))
                i += SERVE_CLASSIFY_CLIENTS
        except (OSError, ValueError) as e:
            errors.append(f"classify client {k}: {type(e).__name__}: {e}")

    gthreads = [threading.Thread(target=generate_client, args=(k,))
                for k in range(SERVE_CLIENTS)]
    cthreads = [threading.Thread(target=classify_client, args=(k,))
                for k in range(SERVE_CLASSIFY_CLIENTS if images else 0)]
    t0 = time.perf_counter()
    for t in gthreads + cthreads:
        t.start()
    for t in gthreads:
        t.join(timeout=900.0)
    wall = time.perf_counter() - t0
    done.set()
    for t in cthreads:
        t.join(timeout=120.0)
    cls_wall = time.perf_counter() - t0
    if any(t.is_alive() for t in gthreads + cthreads):
        errors.append("clients did not finish")
    return wall, gen, [a for per in cls for a in per], cls_wall, errors


def serve_parity(torch, model32, prompts, want) -> dict:
    """The float32 engine's greedy tokens for ``prompts`` against
    ``want`` (models.lm.generate's) in four runs: the dense pool; the
    paged pool; paged with prefix hits (one prompt first, then the seven
    that share its 256-token prefix); paged with the pool cut so that a
    slot is preempted and resumed."""
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.serve import Engine

    pages = len(prompts[0]) // 16       # each prompt's pages
    runs = {"dense": dict(paged_kv=False),
            "paged": dict(prefix_cache=False),
            "paged_prefix_hits": {},
            "paged_preempt": dict(prefix_cache=False,
                                  kv_pages=2 * pages + 4)}
    out = {}
    for name, kw in runs.items():
        eng = Engine(model32, ServeConfig(emit_every_s=0.0, **kw)).start()
        t0 = time.perf_counter()
        try:
            reqs = []
            if name == "paged_prefix_hits":
                reqs.append(eng.submit(prompts[0],
                                       max_new_tokens=SERVE_PARITY_NEW))
                reqs[0].result(timeout=300)
            reqs += [eng.submit(p, max_new_tokens=SERVE_PARITY_NEW)
                     for p in prompts[len(reqs):]]
            got = [r.result(timeout=300) for r in reqs]
        finally:
            eng.stop()
        snap = eng.registry.snapshot()
        equal = got == want
        out[name] = dict(
            tokens_equal_generate=equal, s=time.perf_counter() - t0,
            prefix_hits=snap.get("serve_prefix_hits_total", 0),
            prefill_tokens=snap.get("serve_prefill_tokens_total", 0),
            preemptions=snap.get("serve_kv_preemptions_total", 0))
        check(equal, f"f32 engine ({name}) greedy tokens differ from "
              "generate's: " + str([i for i, (g, w) in enumerate(
                  zip(got, want)) if g != w]))
    check(out["paged_prefix_hits"]["prefix_hits"] >= len(prompts) - 1,
          f"prefix-hit run: {out['paged_prefix_hits']}")
    check(out["paged_preempt"]["preemptions"] >= 1,
          f"pool-cut run preempted nothing: {out['paged_preempt']}")
    return out


def serve_decode_profile(torch, model, prompts) -> dict:
    """One decode iteration of an engine with 8 active slots, driven on
    this thread (the engine not started): wall ms of the iteration and of
    its device step (the host's bookkeeping around the step is the
    difference), then one iteration under the profiler."""
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.serve import Engine

    eng = Engine(model, ServeConfig(emit_every_s=0.0))
    for p in prompts:
        eng.submit(p, max_new_tokens=4 * SERVE_NEW)
    eng._admit()
    check(eng.active_slots() == len(prompts),
          f"{eng.active_slots()} slots active")
    step_s = []
    real_step = eng._step

    def timed_step(*a):
        t = time.perf_counter()
        out = real_step(*a)
        step_s.append(time.perf_counter() - t)
        return out

    eng._step = timed_step
    for _ in range(5):
        eng._decode_iteration()
    step_s.clear()
    laps = []
    for _ in range(40):
        t = time.perf_counter()
        eng._decode_iteration()
        laps.append(time.perf_counter() - t)
    iter_ms = statistics.median(laps) * 1e3
    step_ms = statistics.median(step_s) * 1e3
    prof = profile_step(torch, eng._decode_iteration, iter_ms, ())
    eng.stop()
    return dict(iteration_ms=iter_ms, step_ms=step_ms,
                host_bookkeeping_ms=iter_ms - step_ms,
                kernels=prof.get("device_kernels"),
                device_ms=prof.get("device_ms"),
                device_idle_share=prof.get("device_idle_share"),
                top_kernels=prof.get("top_kernels", [])[:6])


def serve_cli_drain(torch) -> dict:
    """``python -m tpunet_torch.serve`` as a subprocess (the default
    LM's widths, random weights: ``--checkpoint-dir ""``): one request;
    then SIGTERM with a stream in flight, which must finish whole while a
    new request gets 503 with Retry-After; exit 0 and obs_serve records
    in metrics.jsonl, the last one final."""
    import signal
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mdir = SERVE_DIR / "cli"
    shutil.rmtree(mdir, ignore_errors=True)
    log = open(SERVE_DIR / "cli.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpunet_torch.serve", "--checkpoint-dir", "",
         "--metrics-dir", str(mdir), "--port", str(port),
         "--emit-every-s", "1", "--drain-timeout-s", "60"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    res = {}
    try:
        deadline = time.perf_counter() + 180
        while time.perf_counter() < deadline:
            check(proc.poll() is None, f"serve CLI exited {proc.returncode}")
            try:
                if http_call(base, "/healthz", timeout=2)[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        first = http_generate(base, {"tokens": [5, 9, 2],
                                     "max_new_tokens": 16})
        check(first["status"] == 200 and len(first["tokens"]) == 16,
              f"serve CLI request: {first}")
        stream = {}
        t = threading.Thread(target=lambda: stream.update(http_generate(
            base, {"tokens": [7, 1, 4], "max_new_tokens": 1000,
                   "stream": True})))
        t.start()
        time.sleep(0.5)                 # the stream is decoding
        proc.send_signal(signal.SIGTERM)
        got_503 = None
        deadline = time.perf_counter() + 60
        while got_503 is None and time.perf_counter() < deadline:
            try:
                code, out, hdr = http_call(base, "/v1/generate",
                                           {"tokens": [1], "max_new_tokens": 2},
                                           timeout=30)
            except OSError:
                break                   # listener closed: drain finished
            if code == 503:
                got_503 = (out, hdr.get("Retry-After"))
            else:
                time.sleep(0.01)
        t.join(timeout=120)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    recs = [json.loads(line) for line in
            (mdir / "metrics.jsonl").read_text().splitlines()]
    serve_recs = [r for r in recs if r.get("kind") == "obs_serve"]
    res = dict(exit_code=rc, stream_tokens=len(stream.get("tokens") or ()),
               stream_finish=stream.get("finish_reason"),
               draining_503=got_503, obs_serve_records=len(serve_recs),
               last_record_final=bool(serve_recs
                                      and serve_recs[-1].get("final")))
    check(rc == 0, f"serve CLI exited {rc} after SIGTERM")
    check(stream.get("status") == 200 and res["stream_tokens"] == 1000
          and res["stream_finish"] == "length",
          f"in-flight stream through the drain: {res}")
    check(got_503 is not None and got_503[0].get("error") == "draining"
          and got_503[1] is not None and int(got_503[1]) >= 1,
          f"no 503 with Retry-After while draining: {res}")
    check(res["obs_serve_records"] >= 1 and res["last_record_final"],
          f"metrics.jsonl obs_serve records: {res}")
    return res


def serve_sampled_cobatch(base, rows) -> dict:
    """One sampled request alone, then co-batched with 7 others (a prompt
    under one page, so no prefix-cache hit changes its computation): the
    same tokens."""
    solo = {"tokens": rows[-3, :12].tolist(), "max_new_tokens": 64,
            "seed": 4242, **SERVE_SAMPLING}
    alone = http_generate(base, solo)
    others = [{"tokens": rows[-4 - k, :10 + 3 * k].tolist(),
               "max_new_tokens": 64,
               **({"seed": 7 + k, **SERVE_SAMPLING} if k % 2 else {})}
              for k in range(7)]
    together = [None] * 8

    def client(i, body):
        together[i] = http_generate(base, body)

    threads = [threading.Thread(target=client, args=(i, b))
               for i, b in enumerate([solo] + others)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(alone["status"] == 200 and together[0] is not None
          and together[0]["status"] == 200
          and alone["tokens"] == together[0]["tokens"],
          f"sampled request alone {alone['tokens'][:8]} co-batched "
          f"{together[0] and together[0]['tokens'][:8]}")
    return dict(tokens_equal=True, tokens=len(alone["tokens"]),
                greedy_partners=sum(1 for b in others if "seed" not in b))


def serve_pass(torch, model, bodies, rows, pred=None, images=(),
               then=None, cfg_kw=None, drafter_params=None):
    """A fresh engine and server (the ServeConfig defaults with
    ``cfg_kw``, the drafter's ``drafter_params``, the classifier ``pred``
    mounted when given), warmed up on each prefill bucket; then
    ``serve_traffic`` with every launch count at 0, and ``then(base)``
    while the server is still up. Every request must end 200 with its
    full budget. Returns (the generate metrics, the classify answers, the
    launch counts)."""
    import numpy as np

    from tpunet_torch.config import ServeConfig
    from tpunet_torch.serve import ClassifyBatcher, Engine, ServeServer

    cfg = ServeConfig(emit_every_s=0.0, **(cfg_kw or {}))
    engine = Engine(model, cfg, drafter_params=drafter_params)
    reg = engine.registry
    batcher = None if pred is None else ClassifyBatcher(
        pred, batch_max=cfg.classify_batch_max,
        window_ms=cfg.classify_window_ms, registry=reg)
    server = ServeServer(engine, classify_batcher=batcher, port=0).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        # Warm-up, not counted: each prefill bucket, decode, classify.
        for n in (8, 100, 400):
            warm = http_generate(base, {"tokens": rows[-2, :n].tolist(),
                                        "max_new_tokens": 4})
            check(warm["status"] == 200, f"warm-up request: {warm}")
        if batcher is not None:
            batcher.submit(images[0], timeout=120.0)
        torch.cuda.synchronize()
        before = reg.snapshot()
        reg.reset_window()
        reset_launch_counts()
        wall, answers, cls, cls_wall, errors = serve_traffic(
            base, bodies, images, pred.class_names if pred else ())
        launches = launch_counts()
        snap = reg.snapshot()
        check(not errors, f"serve traffic failed: {errors[:3]}")
        bad = [(i, a and a["status"], a and a["finish_reason"])
               for i, a in enumerate(answers)
               if a is None or a["status"] != 200
               or len(a["tokens"] or ()) != SERVE_NEW
               or a["finish_reason"] != "length"]
        check(not bad, f"requests without 200 and {SERVE_NEW} tokens: "
              f"{bad[:4]}")
        flash = {k: v for k, v in launches.items() if k.startswith("flash")}
        check(sum(flash.values()) == 0, f"flash launches while serving: "
              f"{flash}")
        gen_tokens = sum(len(a["tokens"]) for a in answers)

        def delta(key):
            return snap.get(key, 0) - before.get(key, 0)

        metrics = dict(
            requests=len(answers), clients=SERVE_CLIENTS,
            classify_clients=SERVE_CLASSIFY_CLIENTS if images else 0,
            wall_s=wall, generated_tokens=gen_tokens,
            generated_tokens_per_s=gen_tokens / wall,
            requests_per_s=len(answers) / wall,
            ttft_p50_ms=snap["serve_ttft_s_p50"] * 1e3,
            ttft_p99_ms=snap["serve_ttft_s_p99"] * 1e3,
            token_p50_ms=snap["serve_token_s_p50"] * 1e3,
            token_p99_ms=snap["serve_token_s_p99"] * 1e3,
            e2e_p50_ms=snap["serve_e2e_s_p50"] * 1e3,
            prompt_tokens=sum(len(b["tokens"]) for b in bodies),
            prefill_tokens=delta("serve_prefill_tokens_total"),
            prefix_hits=delta("serve_prefix_hits_total"),
            prefix_cow=delta("serve_prefix_cow_total"),
            decode_steps=delta("serve_decode_steps_total"),
            prefills=delta("serve_prefills_total"),
            preemptions=delta("serve_kv_preemptions_total"),
            flash_launches=flash)
        if cfg.spec_decode:
            drafted = delta("serve_spec_draft_tokens_total")
            metrics.update(
                spec_draft_tokens=drafted,
                spec_accepted_tokens=delta(
                    "serve_spec_accepted_tokens_total"),
                spec_verify_steps=delta("serve_spec_verify_steps_total"),
                spec_acceptance_rate=delta(
                    "serve_spec_accepted_tokens_total") / max(drafted, 1),
                drafter_pool_bytes=engine.drafter_pool_bytes())
        if images:
            cls_ms = np.array([s for _, s, _ in cls]) * 1e3
            metrics.update(
                classify_requests=len(cls),
                classify_requests_per_s=len(cls) / cls_wall,
                classify_p50_ms=float(np.percentile(cls_ms, 50)),
                classify_p99_ms=float(np.percentile(cls_ms, 99)),
                classify_batches=delta("serve_classify_batches_total"))
        if then is not None:
            metrics["then"] = then(base)
    finally:
        server.drain(timeout=120.0)
    return metrics, cls, launches


def phase_serve_engine(torch) -> dict:
    """The LM serving engine behind its HTTP server on the card: 8
    closed-loop clients send 48 /v1/generate requests at the LM phases'
    full width (bf16, the ServeConfig defaults: 8 slots, buckets
    32/128/512, paged KV of 16-token pages, the prefix cache, device
    sampling), first alone (then one sampled request alone and
    co-batched), then while 2 clients cycle phase 4's images through
    /v1/classify (MobileNetV2 1.0 at 224 px, the hand depthwise), each
    on a fresh server. Then a profiled decode iteration, the float32
    engine's greedy tokens against generate's (dense, paged, prefix
    hits, preemption), and the CLI's SIGTERM drain."""
    import numpy as np

    from tpunet_torch.config import DataConfig, ModelConfig
    from tpunet_torch.infer.predict import Predictor, preprocess
    from tpunet_torch.models import create_model
    from tpunet_torch.models.lm import generate

    SERVE_DIR.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(SEED + 900)
    state = create_model(lm_config("float32", 0.0), device="cpu",
                         generator=gen).state_dict()
    model = create_model(lm_config("bfloat16", 0.0), device="cuda")
    model.load_state_dict(state)
    bodies, rows, prefix = serve_prompts()

    alone, _, _ = serve_pass(torch, model, bodies, rows,
                             then=lambda base: serve_sampled_cobatch(
                                 base, rows))
    emit("serve_engine_generate_only", **alone)

    # The classifier of phase_main_path: its weights and BN statistics,
    # its 48 images.
    cgen = torch.Generator().manual_seed(SEED)
    ref32 = create_model(ModelConfig(dtype="float32", use_pallas_depthwise=True),
                         device="cpu", generator=cgen)
    randomize_bn(torch, ref32, cgen)
    pred = Predictor(ModelConfig(use_pallas_depthwise=True), DataConfig(),
                     state_dict=ref32.state_dict(), device="cuda")
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, (*REQUEST_SIZES[i % 3], 3), np.uint8)
              for i in range(N_IMAGES)]
    traffic, cls, launches = serve_pass(torch, model, bodies, rows, pred,
                                        images)
    batches = traffic["classify_batches"]
    check(len(cls) >= 8 and launches["depthwise_conv3x3"] == 17 * batches,
          f"{launches['depthwise_conv3x3']} depthwise launches for "
          f"{batches} classify forwards (want 17 each), {len(cls)} answers")
    # /v1/classify against Predictor.predict_probs: phase 4's gate is 2
    # bf16 ulps of the largest logit; a softmax moves a probability by at
    # most half the largest logit move, so 2^-7 * max|logit|.
    errs = []
    with torch.inference_mode():
        for idx in sorted({i for i, _, _ in cls}):
            ref = pred.predict_probs(images[idx])
            x = preprocess(images[idx], pred.data_cfg, "cuda")[None]
            gate = 2.0**-7 * pred.model(x.permute(0, 3, 1, 2)).abs().max().item()
            err = max(float(np.abs(p - ref).max())
                      for i, _, p in cls if i == idx)
            errs.append((err, gate, idx))
    worst = max(errs, key=lambda e: e[0] / e[1])
    check(worst[0] <= worst[1], f"classify image {worst[2]}: probs "
          f"{worst[0]} from predict_probs > {worst[1]}")
    traffic.update(
        depthwise_launches=launches["depthwise_conv3x3"],
        depthwise_launches_per_batch=launches["depthwise_conv3x3"] / batches,
        classify_probs_max_err=max(e for e, _, _ in errs),
        classify_probs_gate_min=min(g for _, g, _ in errs))
    emit("serve_engine", **traffic)
    del pred

    prompts8 = [np.concatenate([prefix, rows[40 + i, :SERVE_PARITY_SUFFIX]])
                for i in range(8)]
    decode = serve_decode_profile(torch, model, prompts8)
    emit("serve_decode_profile", **decode)
    del model
    torch.cuda.empty_cache()
    model32 = create_model(lm_config("float32", 0.0), device="cuda")
    model32.load_state_dict(state)
    with torch.inference_mode():
        buf = generate(model32, torch.from_numpy(np.stack(prompts8)).cuda(),
                       SERVE_PARITY_NEW)
    want = buf[:, len(prompts8[0]):].tolist()
    parity = serve_parity(torch, model32, prompts8, want)
    emit("serve_parity_f32", **parity)
    del model32
    torch.cuda.empty_cache()
    cli = serve_cli_drain(torch)
    emit("serve_cli", **cli)
    return dict(traffic, decode=decode, alone=alone)


def item5_int8_gates(torch) -> dict:
    """int8 KV pages on the card: the quantizer against the CPU's, and
    the int8 paged attend against the float32 attend (on the card) over
    the same pool's K/V gathered and dequantised on the host, so that
    the two differ only in the int8 write, gather and dequantisation."""
    from tpunet_torch.models.vit import (_masked_attend, paged_decode_attend,
                                         quantize_kv_rows)

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 1200)
    x = torch.randn(4096, LM_HEADS, LM_HIDDEN // LM_HEADS,
                    generator=g).to(torch.bfloat16)
    x[7] = 0                          # all-zero row: scale 1
    x[99, 1, 5] = 300.0               # outlier row
    want_q, want_s = quantize_kv_rows(x)
    got_q, got_s = quantize_kv_rows(x.cuda())
    codes_equal = torch.equal(got_q.cpu(), want_q)
    scales_equal = torch.equal(got_s.cpu(), want_s)
    check(codes_equal and scales_equal,
          f"int8 quantizer on the card: codes equal {codes_equal}, scales "
          f"bit-equal {scales_equal}")
    slots, pt, h, d = 8, 16, LM_HEADS, LM_HIDDEN // LM_HEADS
    per_row = LM_T // pt
    rows = (slots * per_row + 1) * pt
    attend = {}
    for t in (1, SPEC_K + 1):
        table = (torch.randperm(slots * per_row, generator=g) + 1).view(
            slots, per_row).int()
        pos = torch.randint(0, LM_T - t + 1, (slots,), generator=g)
        active = torch.ones(slots, dtype=torch.bool)
        active[5] = False
        ck, cv = (torch.randint(-127, 128, (rows, h, d), generator=g,
                                dtype=torch.int8) for _ in range(2))
        sk, sv = (torch.rand(rows, generator=g) * 0.05 + 1e-3
                  for _ in range(2))
        q, k, v = (torch.randn(slots, t, h, d, generator=g)
                   for _ in range(3))
        dev = [a.cuda() for a in (q, k, v, ck, cv, pos, table, active, sk,
                                  sv)]
        got = paged_decode_attend(*dev[:7], pt, active=dev[7],
                                  scale_k=dev[8], scale_v=dev[9])
        ck, cv, sk, sv = (a.cpu() for a in (dev[3], dev[4], dev[8], dev[9]))
        flat = (table.long()[:, :, None] * pt
                + torch.arange(pt)[None, None, :]).reshape(-1)
        kf = (ck[flat].float() * sk[flat, None, None]).view(slots, -1, h, d)
        vf = (cv[flat].float() * sv[flat, None, None]).view(slots, -1, h, d)
        want = _masked_attend(dev[0], kf.cuda(), vf.cuda(),
                              (pos[:, None] + torch.arange(t)).cuda())
        err = (got - want).abs().max().item()
        attend[f"t{t}"] = err
        check(err <= 1e-5, f"int8 paged attend (T {t}) {err} from the "
              "float32 attend over the host-dequantised pool")
    return dict(quantizer_rows=x.shape[0], codes_equal=codes_equal,
                scales_bit_equal=scales_equal, attend_max_abs_err=attend,
                attend_tol=1e-5)


def first_mismatch(torch, model32, prompts, got, want):
    """The first request and position where ``got`` leaves ``want``, and
    the top-2 gap of the float32 forward's logits there."""
    for i, (g_, w_) in enumerate(zip(got, want)):
        j = next((j for j, (a, b) in enumerate(zip(g_, w_)) if a != b), None)
        if j is None:
            continue
        seq = torch.tensor(list(prompts[i]) + w_[:j], device="cuda")[None]
        with torch.inference_mode():
            top2 = model32(seq)[0, -1].topk(2).values
        return dict(request=i, position=j,
                    top2_gap=float(top2[0] - top2[1]))
    return None


def run_engine(model, prompts, cfg_kw, submit_kw):
    """A started engine of the ServeConfig defaults and ``cfg_kw``:
    ``prompts`` submitted together, with ``submit_kw`` (a dict, or one a
    prompt); returns (the engine, its token lists, its free list's size
    at start)."""
    from tpunet_torch.config import ServeConfig
    from tpunet_torch.serve import Engine

    eng = Engine(model, ServeConfig(emit_every_s=0.0, **cfg_kw))
    free0 = len(eng._free_pages)
    if isinstance(submit_kw, dict):
        submit_kw = [submit_kw] * len(prompts)
    eng.start()
    try:
        reqs = [eng.submit(p, **kw) for p, kw in zip(prompts, submit_kw)]
        got = [r.result(timeout=300) for r in reqs]
    finally:
        eng.stop()
    return eng, got, free0


def item5_spec_f32(torch, model32, prompts, want) -> dict:
    """Speculative decoding in float32 at K 4: greedy tokens equal to
    generate's with self-speculation and with a seeded half-width
    drafter; a sampled stream equal to spec-off's; counters that balance
    and a pool that gets every page back."""
    out = {}
    spec = dict(spec_decode=True, spec_k=SPEC_K)
    for name, wm in (("self", 1.0), ("seeded_half", 0.5)):
        t0 = time.perf_counter()
        eng, got, free0 = run_engine(model32, prompts,
                                     dict(spec, spec_draft_width_mult=wm),
                                     dict(max_new_tokens=SERVE_PARITY_NEW))
        snap = eng.registry.snapshot()
        drafted = snap["serve_spec_draft_tokens_total"]
        acc = snap["serve_spec_accepted_tokens_total"]
        rej = snap["serve_spec_rejected_tokens_total"]
        cached = eng._prefix.pages_cached if eng._prefix else 0
        out[name] = dict(
            tokens_equal_generate=got == want, s=time.perf_counter() - t0,
            draft_tokens=drafted, accepted=acc, rejected=rej,
            verify_steps=snap["serve_spec_verify_steps_total"],
            acceptance_rate=acc / max(drafted, 1),
            drafter_pool_bytes=eng.drafter_pool_bytes(),
            kv_pool_bytes=eng.kv_pool_bytes(),
            free_at_start=free0, free_at_end=len(eng._free_pages),
            prefix_cached=cached)
        check(got == want, f"f32 spec ({name}) greedy tokens differ from "
              f"generate's: {first_mismatch(torch, model32, prompts, got, want)}")
        check(drafted > 0 and acc + rej == drafted,
              f"spec ({name}) counters: {out[name]}")
        check(len(eng._free_pages) + cached == free0,
              f"spec ({name}) leaked pages: {out[name]}")
    sampled = [dict(max_new_tokens=SERVE_PARITY_NEW, seed=2000 + i,
                    **SERVE_SAMPLING) for i in range(len(prompts))]
    _, base, _ = run_engine(model32, prompts, {}, sampled)
    _, on, _ = run_engine(model32, prompts,
                          dict(spec, spec_draft_width_mult=0.5), sampled)
    check(on == base, "sampled streams with spec on differ from spec "
          f"off's: requests {[i for i, (a, b) in enumerate(zip(on, base)) if a != b]}")
    out["sampled_streams_equal"] = len(on)
    return out


def item5_int8_readings(torch, model, prompts) -> dict:
    """bf16 serving: the share of greedy tokens an int8 pool gives like
    the bf16 pool on the parity prompts, the bytes a cached token costs
    in each (gate: int8 below 0.6 of bf16), and the pages each holds in
    the bf16 pool's memory."""
    toks, bpt, pool = {}, {}, {}
    for kv in ("auto", "int8"):
        eng, toks[kv], _ = run_engine(model, prompts, dict(kv_dtype=kv),
                                      dict(max_new_tokens=SERVE_PARITY_NEW))
        bpt[kv] = eng.kv_bytes_per_token()
        pool[kv] = eng.kv_pool_bytes()
    same = sum(a == b for ga, gb in zip(toks["auto"], toks["int8"])
               for a, b in zip(ga, gb))
    total = sum(len(g) for g in toks["auto"])
    first = [next((j for j, (a, b) in enumerate(zip(ga, gb)) if a != b),
                  None) for ga, gb in zip(toks["auto"], toks["int8"])]
    ratio = bpt["int8"] / bpt["auto"]
    check(ratio < 0.6, f"int8 kv_bytes_per_token {bpt['int8']} is "
          f"{ratio:.3f} of bf16's {bpt['auto']}")
    pt = 16                              # the default kv_page_tokens
    return dict(greedy_tokens_alike_share=same / total,
                first_divergence=first, bytes_per_token_bf16=bpt["auto"],
                bytes_per_token_int8=bpt["int8"], int8_over_bf16=ratio,
                pool_bytes=pool,
                pages_in_bf16_pool_bytes={
                    kv: int(pool["auto"] // (b * pt))
                    for kv, b in bpt.items()})


def item5_spec_bf16(torch, model, bodies, rows, alone) -> dict:
    """Phase 13's traffic (8 clients, 48 requests, bf16) with self-
    speculation, and its first SPEC_FITTED_REQUESTS requests with a
    half-width drafter fitted by fit_drafter to the traffic's prompts
    (their first SPEC_FIT_PROMPT tokens), beside phase 13's spec-off
    pass. Readings only."""
    import numpy as np

    from tpunet_torch.models.lm import init_lm
    from tpunet_torch.serve.spec import fit_drafter

    keys = ("requests", "generated_tokens_per_s", "token_p50_ms",
            "ttft_p50_ms", "e2e_p50_ms", "wall_s", "decode_steps")
    out = {"off": {k: alone[k] for k in keys}}
    spec = dict(spec_decode=True, spec_k=SPEC_K)
    self_pass, _, _ = serve_pass(torch, model, bodies, rows,
                                 cfg_kw=dict(spec, spec_draft_width_mult=1.0))
    drafter = model.clone(hidden=LM_HIDDEN // 2)
    init_lm(drafter, torch.Generator().manual_seed(0))
    drafter = drafter.cuda()
    prompts = np.stack([b["tokens"][:SPEC_FIT_PROMPT] for b in bodies])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = fit_drafter(model, drafter, prompts, gen_tokens=SPEC_FIT_NEW,
                         steps=SPEC_FIT_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    del drafter
    fitted, _, _ = serve_pass(torch, model, bodies[:SPEC_FITTED_REQUESTS],
                              rows,
                              cfg_kw=dict(spec, spec_draft_width_mult=0.5),
                              drafter_params=params)
    spec_keys = keys + ("spec_acceptance_rate", "spec_verify_steps",
                        "drafter_pool_bytes")
    out["self"] = {k: self_pass[k] for k in spec_keys}
    out["fitted_half"] = {k: fitted[k] for k in spec_keys}
    out["fit"] = dict(steps=SPEC_FIT_STEPS, prompts=list(prompts.shape),
                      gen_tokens=SPEC_FIT_NEW, wall_s=fit_s)
    return out


def item5_prefix_store(torch, model, prefix, rows) -> dict:
    """Two engines in turn on one store directory, the bf16 pool then
    the int8 pool: the first serves a prompt (the shared prefix, a
    suffix, STORE_SUFFIX tokens past a page boundary) twice, cold and
    through its own prefix cache, spilling its pages; the second starts
    on the store, warm-loads them, prefills only the STORE_SUFFIX
    tokens and gives the tokens of the first's cached run (the same
    pages, the same computation)."""
    import numpy as np

    from tpunet_torch.config import ServeConfig
    from tpunet_torch.serve import Engine
    from tpunet_torch.serve.prefixcache import build_prefix_store

    prompt = np.concatenate([prefix, rows[-5, :64 + STORE_SUFFIX]])
    out = {}
    for kv in ("auto", "int8"):
        d = SERVE_DIR / f"prefix_store_{kv}"
        shutil.rmtree(d, ignore_errors=True)
        cfg = ServeConfig(emit_every_s=0.0, kv_dtype=kv)
        store = build_prefix_store(str(d), lm_config("bfloat16", 0.0), cfg,
                                   device="cuda")
        first = Engine(model, cfg, prefix_store=store).start()
        try:
            cold = first.submit(prompt, max_new_tokens=SERVE_PARITY_NEW
                                ).result(timeout=300)
            hit = first.submit(prompt, max_new_tokens=SERVE_PARITY_NEW
                               ).result(timeout=300)
        finally:
            first.stop()
        second = Engine(model, cfg, prefix_store=store).start()
        try:
            warm = second.submit(prompt, max_new_tokens=SERVE_PARITY_NEW
                                 ).result(timeout=300)
        finally:
            second.stop()
        s1, s2 = first.registry.snapshot(), second.registry.snapshot()
        out[kv] = dict(
            prompt_tokens=len(prompt),
            spills=s1["serve_prefix_spills_total"],
            warm_loads=s2["serve_prefix_warm_loads_total"],
            prefill_tokens=s2["serve_prefill_tokens_total"],
            tokens_equal_first=warm == hit, cold_equals_hit=cold == hit,
            files=len(list(d.glob("*.pfx"))))
        check(out[kv]["warm_loads"] >= 1, f"store ({kv}): {out[kv]}")
        check(out[kv]["prefill_tokens"] == STORE_SUFFIX,
              f"store ({kv}): the warm engine prefilled "
              f"{out[kv]['prefill_tokens']} tokens, want {STORE_SUFFIX}")
        check(warm == hit, f"store ({kv}): warm tokens {warm[:8]} differ "
              f"from the first engine's {hit[:8]}")
    return out


def serve_cli_chaos(torch) -> dict:
    """``python -m tpunet_torch.serve --chaos kill@tokens=N`` (the default
    LM's widths, random weights) as a subprocess: a streamed
    /v1/generate receives exactly N token lines and no done frame, then
    the process dies by SIGKILL."""
    import signal
    import socket
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mdir = SERVE_DIR / "chaos"
    shutil.rmtree(mdir, ignore_errors=True)
    log = open(SERVE_DIR / "chaos.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpunet_torch.serve", "--checkpoint-dir", "",
         "--metrics-dir", str(mdir), "--port", str(port), "--chaos",
         f"kill@tokens={CHAOS_KILL_TOKENS}"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    lines = []
    try:
        deadline = time.perf_counter() + 180
        while time.perf_counter() < deadline:
            check(proc.poll() is None, f"chaos CLI exited {proc.returncode}")
            try:
                if http_call(base, "/healthz", timeout=2)[0] == 200:
                    break
            except OSError:
                time.sleep(0.2)
        req = urllib.request.Request(
            base + "/v1/generate",
            json.dumps({"tokens": [5, 9, 2], "max_new_tokens": 64,
                        "stream": True}).encode(),
            {"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                for line in r:
                    if line.strip():
                        lines.append(json.loads(line))
        except (OSError, ValueError):
            pass                        # the connection dropped
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    res = dict(kill_at=CHAOS_KILL_TOKENS,
               streamed_tokens=sum(1 for ev in lines if "token" in ev),
               done_frame=any(ev.get("done") for ev in lines),
               exit_code=rc)
    check([ev.get("i") for ev in lines] == list(range(CHAOS_KILL_TOKENS)),
          f"chaos stream: {res}")
    check(rc == -signal.SIGKILL, f"chaos CLI exit {rc}, want -9: {res}")
    return res


def phase_serve_item5(torch, serve) -> dict:
    """serve_item5 (docstring, phase 14): int8 pages, speculative
    decoding, the prefix store and chaos on the LM of phase 13. Its
    counts go to 0 before and are read after: the path launches no
    kernel."""
    import numpy as np

    from tpunet_torch.models import create_model
    from tpunet_torch.models.lm import generate

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 900)
    state = create_model(lm_config("float32", 0.0), device="cpu",
                         generator=gen).state_dict()
    bodies, rows, prefix = serve_prompts()
    prompts8 = [np.concatenate([prefix, rows[40 + i, :SERVE_PARITY_SUFFIX]])
                for i in range(8)]
    reset_launch_counts()
    int8 = item5_int8_gates(torch)
    emit("serve_item5_int8_gates", **int8)
    model32 = create_model(lm_config("float32", 0.0), device="cuda")
    model32.load_state_dict(state)
    with torch.inference_mode():
        buf = generate(model32, torch.from_numpy(np.stack(prompts8)).cuda(),
                       SERVE_PARITY_NEW)
    want = buf[:, len(prompts8[0]):].tolist()
    spec32 = item5_spec_f32(torch, model32, prompts8, want)
    emit("serve_item5_spec_f32", **spec32)
    del model32
    torch.cuda.empty_cache()
    model = create_model(lm_config("bfloat16", 0.0), device="cuda")
    model.load_state_dict(state)
    readings = item5_int8_readings(torch, model, prompts8)
    emit("serve_item5_int8", **readings)
    store = item5_prefix_store(torch, model, prefix, rows)
    emit("serve_item5_prefix_store", **store)
    launches = launch_counts()
    check(sum(launches.values()) == 0,
          f"kernel launches on the serve_item5 path: {launches}")
    spec16 = item5_spec_bf16(torch, model, bodies, rows, serve["alone"])
    emit("serve_item5_spec_bf16", **spec16)
    del model
    torch.cuda.empty_cache()
    chaos = serve_cli_chaos(torch)
    emit("serve_item5_chaos", **chaos)
    return dict(launches=launches, s=time.perf_counter() - t0)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def per_step(rows, key) -> float:
    """Sum of ``key`` over the layers of one training step (per-shape value
    times the number of layers with that shape), at batch 128."""
    return sum(r[key] * r["layers"] for r in rows if r.get("layers"))


def kernel_entry(name, source, replaces, launches, rows) -> dict:
    bytes_ms, ops_ms = per_step(rows, "bytes_ms"), per_step(rows, "ops_ms")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(max(r["max_abs_err"], r.get("max_abs_err_b128", 0))
                               for r in rows),
            "ms": per_step(rows, "kernel_ms"),
            "plain_ms": per_step(rows, "plain_ms"),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": per_step(rows, "library_ms")}


def lm_entry(rows, launches_per_step) -> dict:
    """A flash kernel's LM fields of the kernel line: its launches a step
    of the LM's training main path, and per LM step (12 layers) at each
    shape its time, plain version's, SDPA's and bound."""
    out = {"launches_per_step": launches_per_step}
    for shape, r in rows.items():
        bytes_ms, ops_ms = per_step([r], "bytes_ms"), per_step([r], "ops_ms")
        out[shape] = {"ms": per_step([r], "kernel_ms"),
                      "plain_ms": per_step([r], "plain_ms"),
                      "library_ms": per_step([r], "library_ms"),
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": r["bound_by"]}
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        phase_build()
        fwd_rows = phase_kernels(torch)
        train_rows = phase_train_kernels(torch)
        serve_launches = phase_main_path(torch)
        launches, images_per_s, dp_ref = phase_train(torch)
        phase_train_b512(torch)
        epoch = phase_trainer(torch, sync_step_ms=dp_ref["step_ms"],
                              exporters=True)
        torch.cuda.empty_cache()
        phase_dp_step(torch, dp_ref)
        phase_dp_trainer(torch, epoch, dp_ref["step_ms"])
        del dp_ref
        torch.cuda.empty_cache()
        flash_rows = phase_flash_kernels(torch)
        state = vit_state(torch)
        vit_serve_launches = phase_vit_serving(torch, state)
        vit_launches, vit_images_per_s = phase_vit_train(torch, state)
        from tpunet_torch.config import ModelConfig
        phase_trainer(torch, ModelConfig(name="vit_base"),
                      ("--model", "vit_base"), "vit_trainer",
                      sync_step_ms=TRAIN_BATCH / vit_images_per_s * 1e3,
                      window_kernels=FLASH_WINDOW_KERNELS)
        torch.cuda.empty_cache()
        lm_rows = phase_lm_kernels(torch)
        lm_launches, lm_tokens_per_s = phase_lm_train(torch)
        phase_lm_trainer(torch,
                         sync_step_ms=LM_BATCH * LM_T / lm_tokens_per_s * 1e3)
        lm_gen = phase_lm_generate(torch)
        serve = phase_serve_engine(torch)
        item5 = phase_serve_item5(torch, serve)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # Row 1 per training step: the batch-128 times of the depthwise
    # forward's 10 shapes, each times its layer count.
    fwd_b128 = [dict(r["b128"], max_abs_err=r["max_abs_err"],
                     layers=MAIN_SHAPES[(r["shape"][1], r["shape"][3],
                                         r["shape"][4])])
                for r in fwd_rows if "b128" in r]
    dw_entry = kernel_entry("depthwise_conv3x3",
                            "tpunet_torch/csrc/depthwise.cu",
                            "tpunet/ops/depthwise.py:74",
                            launches["depthwise_conv3x3"], fwd_b128)
    # Its launches on the serve_engine path: /v1/classify under the
    # engine's decode load, 17 a batched forward.
    dw_entry["serve_engine"] = {
        "launches": serve["depthwise_launches"],
        "classify_forwards": serve["classify_batches"],
        "launches_per_forward": serve["depthwise_launches_per_batch"]}
    kernels = [
        dw_entry,
        kernel_entry("depthwise_conv3x3_backward",
                     "tpunet_torch/csrc/depthwise.cu",
                     "tpunet/ops/depthwise.py:237",
                     launches["depthwise_conv3x3_backward"],
                     train_rows["depthwise_conv3x3_backward"]),
        kernel_entry("fused_ir_forward", "tpunet_torch/csrc/fused_ir.cu",
                     "tpunet/ops/fused_ir.py:138",
                     launches["fused_ir_forward"],
                     train_rows["fused_ir_forward"]),
        kernel_entry("fused_ir_backward", "tpunet_torch/csrc/fused_ir.cu",
                     "tpunet/ops/fused_ir.py:247",
                     launches["fused_ir_backward"],
                     train_rows["fused_ir_backward"]),
    ]
    # Rows 5-7 per ViT-B/16 training step: 12 layers at batch 128, bf16;
    # launches from the ViT training main path.
    # Each also carries its LM rows: launches a step of the LM's
    # training main path, and per LM step (12 layers at B 16, T 1024,
    # causal; packed: the corpus's segments) its times and bound.
    for name, line in (("flash_attention_forward", 115),
                       ("flash_attention_dq", 393),
                       ("flash_attention_dkv", 437)):
        entry = kernel_entry(name, "tpunet_torch/csrc/flash.cu",
                             f"tpunet/ops/flash.py:{line}",
                             vit_launches[name], flash_rows[name])
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   lm_rows[name]["causal"]["max_abs_err"])
        entry["lm"] = lm_entry(lm_rows[name], lm_launches[name])
        kernels.append(entry)
    emit("summary", seconds=time.perf_counter() - t0,
         serve_depthwise_launches=serve_launches,
         train_images_per_sec_per_chip=images_per_s,
         vit_serve_flash_launches_per_forward=vit_serve_launches,
         vit_train_images_per_sec_per_chip=vit_images_per_s,
         lm_train_tokens_per_sec_per_chip=lm_tokens_per_s,
         lm_decode_new_tokens_per_s=lm_gen["new_tokens_per_s"],
         serve_generated_tokens_per_s=serve["generated_tokens_per_s"],
         serve_ttft_p50_ms=serve["ttft_p50_ms"],
         serve_item5_s=item5["s"])
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    sys.exit(main())
