#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (paddle_tpu_torch) on one NVIDIA card.

Phases, in order (18, 15, 21, 20, 19 and 22 run right after 4, and 18,
16, 21, 20 and 22 right after 5, on the models those build; 17 right
after 12);
any failure exits non-zero before the last line:
  1. card: name and power limit (nvidia-smi); TF32 off for fp32 checks.
  2. build: every CUDA kernel of the port, from the sources in this
     checkout (one nvcc per source, in parallel); the warpgroup kernels of
     the bf16 attention forward (K4 / K6, csrc/flash_fwd_sm90.cu) and
     backward (K5 / K7 / K8, csrc/flash_bwd_sm90.cu) print their
     registers, shared memory and spills, must spill nothing, and must
     hold HGMMA (`wgmma`) instructions in their SASS (cuobjdump).
  3. kernels vs plain: each kernel against its plain PyTorch version on
     the card, at the serving path's shapes and at ragged ones, with
     kernel / plain / library times (CUDA events over a CUDA graph, and
     per eager call) and the memory bound.
  4. Llama-2-7B at full width and depth (bf16, random weights from a
     seed) served through model.generate(use_paged_kv=True): a fixed
     batch, a ragged batch and a batch-repeated prompt; the RMSNorm
     kernel must carry every norm (65 launches per forward, 0 plain),
     and one decode step must not read back to the host. Prefill ms,
     decode ms/token, and the card's share of a decode step (profiler).
  5. GPT-3 1.3B the same way; the LayerNorm kernel carries every norm
     (49 launches per forward, 0 plain).
  6. card vs CPU: tiny Llama-GQA and GPT in fp32 with identical weights
     give identical greedy streams (GenerationSession, fixed and ragged,
     and ContinuousBatchingSession, whose card decode is a CUDA graph);
     with speculative decoding (the n-gram proposer, a one-layer draft
     and the model as its own draft; both sessions, their verify widths
     and the draft's decode step CUDA graphs) the card's streams equal
     the CPU's and the spec-off streams, the spec counts the CPU's, and
     the self-draft accepts every draft; a greedy logprobs=True session
     (raw-logits admit graphs) gives the CPU's streams, each log p within
     CARD_LOGPROB_ATOL of the CPU's.
  7. training kernels vs plain: LayerNorm backward (K3), flash
     attention forward / backward (K4 / K5), the head-major forward /
     one-pass backward (K6 / K7) and the head-major two-kernel backward
     (K8) against their plain versions at the training steps' shapes
     (GPT-3 1.3B, B=4, S=2048, 16 heads of d=128, and B=1, S=16384;
     TinyLlama-1.1B, B=8, S=2048, 32 heads of d=64 over 4 kv heads, which
     the head-major route sees repeated to 32) and at ragged (Sq < Sk, and
     in bf16 Sq > Sk), d=32, fp32 and grouped-query ones (32:1, 8:2, 8:4,
     4:2), every output held per element; K4 alone at one query row (a
     dense decode step: Sq = 1 against Sk = 1, 77, 512, 4096; 16:16 at
     d=128 and 32:4 at d=64; bf16 and fp32) on out and lse, and its card
     time at Llama-2-7B's and TinyLlama's decode shapes beside sdpa's;
     K8 against K7 at S=2048 and
     8192; the kernels a bf16 and an fp32 K4, K5, K6, K7 and K8 call
     launch (by name and grid, from a CUDA graph of the call: in bf16 the
     warpgroup kernels, in fp32 the earlier ones); two forward and two
     backward calls on the same inputs must give the same bytes (K3's
     dx, dw and db too, at [8192, 2048] bf16); over one 32:4 forward and
     backward the allocated memory must not rise by a repeat of k and v;
     gradients through the K1 / K2 autograd Functions; card times beside
     the bound, the plain version and the library call, at the steps'
     shapes (K2 at GPT's [8192, 2048] and K1 at TinyLlama's [16384,
     2048] among them).
  8. GPT-3 1.3B training at full width and depth (B=4, S=2048, bf16 amp
     O2, AdamW with fp32 masters, random weights and tokens from a seed):
     2 warm-up and 3 timed steps on one batch; the loss must be finite
     and fall, and every attention and LayerNorm must run K4/K5 and
     K2/K3 (24/24/49/49 launches per step, 0 plain; the fp32 entries of
     K4/K5/K6 none, in this and every training phase). Step ms, tokens/s,
     model-FLOP utilisation, peak memory and the card's share of a step.
  9. The same with FLAGS_use_fused_attention ([train_fused]): every
     attention block is one fused_self_attention op on K6/K7 (24/24
     launches per step, K4/K5, K8 and the fp32 K7 none) beside K2/K3
     (49/49), 0 plain.
 10. FLAGS_flash_native_layout=0 ([train_hm]) at full width and 2 layers,
     2 steps each: GPT-3 1.3B's width through the unpack route and
     TinyLlama's through the GQA ramp; K6/K7 launch, K4/K5 never.
 11. GPT-3 1.3B at 16K context ([train_long]: max_seq_len 16384, B=1,
     S=16384) with FLAGS_use_fused_attention: the head-major backward is
     above the one-pass budget, so every attention backward runs K8
     (24 K6, 24 K8, 49 K2, 49 K3 launches per step; K4/K5/K7 and the
     fp32 K8 none, 0 plain), as phase 8 otherwise.
 12. TinyLlama-1.1B training as phase 8 at full width and depth (B=8,
     S=2048, GQA 32:4): every attention runs K4/K5 over the shared kv
     heads and every RMSNorm K1 (22/22/45 launches per step, 0 plain).
 13. card vs CPU: one fp32 training step of gpt_tiny, of gpt_tiny with
     FLAGS_use_fused_attention and of llama_tiny at GQA 4:2 (loss, every
     gradient and the updated weights).
 14. the custom-op API ([custom_op]): K9 (csrc/scale.cu) against its
     plain version bit for bit (fp32 and bf16, factors 2, 0.1, 1/3, at
     the hidden state of a GPT-3 1.3B step [4, 2048, 2048] and at small,
     offset, transposed and empty inputs; the FFN's [8192, 8192] bf16 at
     0.5; two calls give the same bytes) and its times at both paths'
     shapes beside the bound and torch.mul; an op registered with K9 and
     its VJP (ops.register_op) forward and backward on a to_tensor
     tensor on the card (1 + 1 launches, 0 plain); a PyLayer forward and
     backward on the card; an FFN at GPT-3 1.3B's width (Linear(2048,
     8192), a registered gelu-like op, the K9 op at 0.5, Linear(8192,
     2048)) trained 10 SGD steps under amp O2 on 8192 rows (loss falls,
     K9 20 launches counted from 0, 0 plain; the first step's K9 calls
     equal the plain version bit for bit); cpp_extension.load's host ops
     on 1M floats on the card.
 15. Llama-2-7B through the continuous-batching serving core
     ([serve_cb_llama]): ContinuousBatchingSession(model, slots=4,
     max_prompt_len=512, kv_block_size=64, chunk=8) with the default pool
     (every slot can hold max_seq_len), bf16, random weights from a seed;
     12 chat requests of 32 new tokens (cb_prompts: a shared 256-token
     system prompt, a full hit, ragged prompts of 40-480 tokens, 8
     submitted before the first step and 4 after the third). The decode
     chunk runs as one CUDA graph per session and each admit width as
     one CUDA graph captured at its first use: the session's own graphs
     hold exactly 8 x 65 RMSNorm kernels (chunk) and 65 (each admit) and
     no other norm, and the run's launches are the captures' warm-ups
     plus the replays times the graphs'; one chunk, and the first admit
     at each width the run uses (on a third pass of the same traffic),
     replayed from their graphs equal the same programs run eagerly from
     the same state (tokens, lengths, every pool byte), and a sampled
     session streams the same bytes from graphs and with every program
     eager. The session runs the default engine, the overlapped one:
     chunks launch from staged plans (at least one), each still running
     on the card when step() returns (a CUDA event recorded after its
     replay not yet complete), and the bookkeeping and staging behind it
     run under torch.cuda.set_sync_debug_mode("error"). TTFT is read
     cold (the run above) and warm (a second pass of the traffic, prefix
     cache flushed). Every request, with the prefix
     cache on
     and off, is held to an independent B=1 paged forward of its own
     tokens: its first-token logits within 16 bf16 ulps, each of its 32
     tokens within 32 ulps of that forward's best; prefill tokens =
     prompt tokens - prefix-hit tokens, at least 4 hits and 1
     copy-on-write, the pool quiescent after run(). TTFT median and p90
     (beside the eager admits' in PERF.md), decode ms per
     token, tokens/s, the card's busy share of a chunk (CUDA events
     around the replay over the chunk step's host time; on the
     overlapped engine that host time no longer brackets the step's own
     replay) and over decode stretches (the reading [serve_overlap_*]
     gives the sequential engine), the overlap fraction, peak memory.
 16. GPT-3 1.3B the same way ([serve_cb_gpt]; 8 x 49 LayerNorm kernels
     a chunk).
 17. The JAX package's own single-chip training recipes ([train_recipe]):
     GPT-3 1.3B (bench.py `bench_gpt13b`) and TinyLlama-1.1B (`bench_llama`)
     at B=8, S=2048, full width and depth, recompute on every block,
     AdamW with bf16 moments, stochastic rounding and use_multi_tensor,
     decorate(O2, master_weight=False) (GPT also a linear warm-up into a
     cosine decay and a global-norm clip at 1.0), 2 warm-up and 3 timed
     steps: losses finite; every parameter bf16, no fp32 master, bf16
     moments above 2^18 elements and fp32 below; the recomputed forward
     runs each block's norms and attention again (GPT 97 K2, 49 K3, 48
     K4, 24 K5 a step; TinyLlama 89 K1, 44 K4, 22 K5; 0 plain). Step ms,
     tokens/s, MFU (the recomputed forward not counted), peak memory, the
     card's share of a step, the persistent bytes and the state's dtype
     census.
 18. The models' default generate() ([generate_default]) on the
     serving models (B=4, prompt 128): the dense (k, v) cache (32 tokens:
     K4 L x 32 launches, the prefill and one query row a step; the norm
     (2L + 1) x 32; 0 plain), the eager paged loop (use_paged_kv=True,
     aot=False), and for GPT use_cache=False (8 tokens) and the dense
     cache at a 77-token prompt (B=2: the packed projection's q, k, v
     views into K4); every token held to an independent B=1 forward
     within 2 x 16 bf16 ulps of its best; tokens equal to the AOT paged
     stream counted; prefill ms, decode ms/token, the card's busy share,
     peak memory.
 19. Llama-2-7B through the scheduler's overload paths
     ([serve_cb_sched]): the [serve_cb_llama] traffic with
     prefill_chunk=128 and kv_pool_bytes of 18 blocks (half of what the 4
     slots' longest requests hold), a request whose deadline passed
     before submission (expired), a priority-5 request that preempts a
     running one, and one forced preempt() mid-decode: every finished
     stream held by cb_hold, the first admit at each width graph against
     eager, the longest prompt over >= ceil(len / 128) admits, the
     preemptions, expiry and pool quiescence checked; streams equal to
     [serve_cb_llama]'s counted.
 20. Speculative decoding on the serving models ([serve_spec]) with the
     [serve_cb_*] traffic and session (4 slots, prompts to 512, blocks
     of 64; k = 4): Llama-2-7B with the n-gram proposer, then with a
     TinyLlama-1.1B draft (its vocabulary; max_seq_len raised to 4096;
     weights from another seed); GPT-3 1.3B with the n-gram proposer,
     then as its own draft. No decode chunk: each decode step is one
     verify window, one CUDA graph per width captured at its first use,
     holding exactly 2L + 1 norm kernels and no other norm (the draft's
     decode step one graph of 45 / 49); the draft engine's lengths equal
     the target's after every window; every stream held by cb_hold and
     the streams byte-equal to [serve_cb_*]'s counted; the pool
     quiescent. With the n-gram proposer also: the first window at each
     width replayed from its graph equals the same window run eagerly
     from the same state (tokens, accepted counts, boundaries, lengths,
     every pool byte), and a sampled session streams the same bytes from
     graphs, eagerly and with PADDLE_SPEC_DEVICE_ACCEPT=0. Readings:
     acceptance, tokens emitted a row-window, verify card ms a window
     (CUDA events around the replay) beside the step's host ms and the
     proposal's, ms per generated token and tokens/s beside
     [serve_cb_*]'s, TTFT cold and warm, capture ms per width, peak
     memory. The default (overlapped) engine's staged windows are held as
     in 15.
 21. The overlapped engine against the sequential one
     ([serve_overlap_llama], [serve_overlap_gpt]) on the serving models,
     where [serve_cb_*] (the overlapped engine) does not reach: the
     sequential engine on [serve_cb_*]'s traffic, one cold pass whose
     streams are [serve_cb_*]'s byte for byte; for GPT-3 1.3B that
     traffic with n-gram verify windows (k = 4) on both engines; 4
     periodic prompts at once with the n-gram proposer on both engines
     (where windows stage); and 4 sampled requests with pinned seeds
     through the device sampler and logprobs=True (raw-logits admit
     graphs, width-1 replays a decode token); each two-way run served
     twice by one session (cold, then warm): the engines' streams and
     stats byte-equal, logprobs' streams the device sampler's with every
     log p finite and <= 0; for each pass the staged and mispredicted
     steps, ms per generated token, the card's busy share over decode
     stretches (CUDA events; [serve_cb_*] gives the same reading), the
     overlap fraction and the host ms hidden behind replays (step
     profiler), and the norm kernel's launches, read from the nodes of
     every graph each session captured (tools/engine_ab.py times the
     two engines against each other).
 22. Quantized serving ([serve_quant_llama], [serve_quant_gpt]) with the
     [serve_cb_*] traffic and session: int8 and int4 weights
     (quantize_weights) over an int8 pool (kv_dtype): [serve_cb_*]'s
     figures beside the bf16 run's, peak memory (Llama int8 at most
     QUANT_PEAK_GB), the memz ledger's weights (raw and quant bytes) and
     pool, the pool's blocks, and the streams equal to the bf16 run's
     (counted, not gated); an unquantized session over an int8 pool
     serving the dequantized image of each quantized session's payloads
     (dequantize_weight written into the model's weights before it is
     built) streams every request byte for byte as the quantized one; in
     the int8 session a payload zeroed between two chunks changes the
     chunk and restored gives it back byte for byte; the norm kernel's
     launches read from every graph each quantized session captured (65
     / 49 a forward, none of the other norm); for Llama-2-7B,
     [serve_cb_sched]'s overload traffic over an int8 pool at the same
     byte budget (35 blocks where bf16 holds 18), its preemptions and
     expiries printed beside the bf16 run's.
Then one JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}. Full records go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py    (from the repository root; one card)
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS = 67e12             # H100 SXM fp32 rate outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core rate
BATCH, PROMPT, NEW, BLOCK = 4, 128, 64, 64
TRAIN_B, TRAIN_S = 4, 2048     # the training step's batch and sequence
LONG_S = 16384                 # [train_long]'s sequence (B=1)
TRAIN_LLAMA_B = 8              # TinyLlama's batch (bench.py bench_llama)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def sync_time(fn):
    """Host seconds of fn() bracketed by device synchronisation."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _median_event_ms(run, iters, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def eager_ms(fn, iters=50, reps=21, warmup=5):
    """Median over `reps` of the mean ms per call of `iters` back-to-back
    eager calls (CUDA events). For a small kernel this is the host's
    cost of one call: the card waits for the host."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _median_event_ms(run, iters, reps)


def device_ms(fn, iters=50, reps=21):
    """Median over `reps` of the card's ms per call: `iters` calls
    captured in one CUDA graph and replayed (CUDA events), so no host
    dispatch cost is included. Inputs stay in L2 between calls, as the
    serving path's do (each norm reads what the op before it wrote)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _median_event_ms(graph.replay, iters, reps)


def device_breakdown(fn, top=6):
    """(card ms, top kernels) of fn() under torch.profiler: the sum of the
    device events' times, and the kernels that take most of it. (None, [])
    when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # an op registry span ("op:<name>", ops/registry.py) is a range
        # over kernels that have rows of their own
        if not str(e.device_type).endswith("CUDA") or e.key.startswith(
                "op:"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / 1e3, e.key, e.count))
    rows.sort(key=lambda r: -r[0])
    total = sum(r[0] for r in rows)
    return (total or None), [dict(kernel=k[:100], ms=ms, calls=c)
                             for ms, k, c in rows[:top]]


def bf16_ulp(ref):
    mag = ref.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def max_err_within_tol(got, ref):
    """(max |got - ref|, within tolerance, worst element). Kernel and
    plain version sum a row in different orders, so they differ by fp32
    rounding of the row's terms: the tolerance is 1e-5 of the row's
    largest output (this also covers outputs near 0, where a bias
    cancels x*w), plus 1e-5 of the output in fp32 or one ulp of the
    output in bf16 (the cast may then round either way)."""
    got, r = got.detach(), ref.float()
    diff = (got.float() - r).abs()
    row = 1e-5 * r.abs().amax(dim=-1, keepdim=True)
    own = bf16_ulp(ref) if got.dtype == torch.bfloat16 else 1e-5 * r.abs()
    excess = diff / (row + own)
    i = int(torch.argmax(excess))
    worst = dict(ref=float(r.reshape(-1)[i]),
                 got=float(got.float().reshape(-1)[i]),
                 tol=float((row + own).expand_as(r).reshape(-1)[i]))
    return float(diff.max()), bool((excess <= 1).all()), worst


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return line


# The warpgroup (`wgmma`) kernels by source, by the name fragment of their
# symbols: the bf16 forward (K4 and K6), and the backward (K7: the kv
# kernel with dq; K5 and K8: the kv kernel without it and the dq kernel)
SM90_KERNELS = {
    "flash_fwd_sm90": tuple(f"fwd_kernelILi{d}E" for d in (32, 64, 128)),
    "flash_bwd_sm90": tuple(f"{k}ILi{d}E{t}" for d in (32, 64, 128)
                            for k, t in (("bwd_kv_kernel", "Lb1E"),
                                         ("bwd_kv_kernel", "Lb0E"),
                                         ("bwd_dq_kernel", "")))}


def _ptxas_report(log):
    """{kernel symbol: 'N registers, M bytes smem, spills ...'} from
    nvcc's -Xptxas -v output, and the lines that warn."""
    report, name, warnings = {}, None, []
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            report[name] = []
        elif name and ("registers" in ln or "spill" in ln):
            report[name].append(ln.split(":", 1)[-1].strip())
        if "arning" in ln or "Performance" in ln:
            warnings.append(ln.strip())
    return {k: "; ".join(v) for k, v in report.items()}, warnings


def sass_hgmma_counts(lib):
    """{kernel symbol: count of HGMMA instructions} in the SASS of a
    built library (cuobjdump -sass)."""
    from paddle_tpu_torch import csrc

    tool = Path(csrc.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-500:]}")
    counts, name = {}, None
    for ln in out.stdout.splitlines():
        if "Function : " in ln:
            name = ln.split("Function : ")[1].strip()
            counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


def phase_build():
    from paddle_tpu_torch import csrc

    t0 = time.perf_counter()
    logs = csrc.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} of {len(csrc.sources())} kernel libraries "
          f"built in {secs:.2f} s ({', '.join(sorted(logs)) or 'cached'})")
    for name, log in sorted(logs.items()):
        if name in SM90_KERNELS:
            continue
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")
    rec = dict(build_s=secs, ptxas={}, hgmma={})
    for source, frags in SM90_KERNELS.items():
        if source in logs:
            report, warnings = _ptxas_report(logs[source])
            for w in warnings:
                print(f"[build] {source}: {w}")
            rec["ptxas"].update({k: v for k, v in report.items()
                                 if any(f in k for f in frags)})
        hgmma = sass_hgmma_counts(
            csrc.library_path(csrc._SRC_DIR / f"{source}.cu"))
        for frag in frags:
            names = [n for n in hgmma if frag in n]
            check(len(names) == 1, f"{source}: {len(names)} kernels named "
                                   f"*{frag}* in the SASS")
            rec["hgmma"][frag] = hgmma[names[0]]
            check(hgmma[names[0]] > 0, f"{names[0]}: no HGMMA in its SASS")
            ptx = rec["ptxas"].get(names[0])
            check(ptx is None or "0 bytes spill stores, 0 bytes spill loads"
                  in ptx, f"{names[0]} spills: {ptx}")
            print(f"[build] {source} {frag}: {hgmma[names[0]]} HGMMA in "
                  f"SASS; {ptx or 'built earlier'}")
    return rec


def _bound(rows, d, itemsize, param_vectors, flops_per_elem):
    bytes_ = rows * d * 2 * itemsize + param_vectors * d * itemsize
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = rows * d * flops_per_elem / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels():
    """Each kernel against its plain version on the card; times at the
    serving path's shapes (rows = B for decode, B*prompt for prefill)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    g = torch.Generator(device="cuda").manual_seed(0)
    rec = {"rms_norm": {"max_abs_err": 0.0, "shapes": []},
           "layer_norm": {"max_abs_err": 0.0, "shapes": []}}

    def inputs(rows, d, dt):
        x = torch.randn(rows, d, generator=g, device="cuda") * 2 + 0.5
        w = torch.randn(d, generator=g, device="cuda")
        b = torch.randn(d, generator=g, device="cuda")
        return x.to(dt), w.to(dt), b.to(dt)

    # correctness: serving shapes, LayerNorm at the training step's, a
    # rows count that is not a multiple of 8, and a d that takes the
    # scalar (non-vector) path
    for dt in (torch.bfloat16, torch.float32):
        for rows, d in ((4, 4096), (512, 4096), (77, 4096), (3, 1001)):
            x, w, _ = inputs(rows, d, dt)
            got = fused_ops.rms_norm_cuda(x, w, 1e-6)
            err, ok, worst = max_err_within_tol(
                got, fused_ops._rms_norm_ref(x, w, 1e-6))
            check(ok, f"rms_norm {rows}x{d} {dt}: max err {err}, worst "
                      f"element {worst}")
            rec["rms_norm"]["max_abs_err"] = max(
                rec["rms_norm"]["max_abs_err"], err)
        for rows, d in ((4, 2048), (512, 2048), (TRAIN_B * TRAIN_S, 2048),
                        (77, 2048), (3, 1001)):
            x, w, b = inputs(rows, d, dt)
            for wb in ((w, b), (None, None), (w, None)):
                got = norm.layer_norm_cuda(x, *wb, 1e-5)
                err, ok, worst = max_err_within_tol(
                    got, norm._ln_ref(x, *wb, 1e-5))
                check(ok, f"layer_norm {rows}x{d} {dt} w/b="
                          f"{[p is not None for p in wb]}: max err {err}, "
                          f"worst element {worst}")
                rec["layer_norm"]["max_abs_err"] = max(
                    rec["layer_norm"]["max_abs_err"], err)
    torch.cuda.synchronize()

    def timed(rows, d, kernel, plain, library, bound):
        t = dict(rows=rows, d=d, dtype="bfloat16", bound_ms=bound[0],
                 bound_by=bound[1])
        for key, fn in (("ms", kernel), ("plain_ms", plain),
                        ("library_ms", library)):
            t[key] = None if fn is None else device_ms(fn)
            t["eager_" + key] = None if fn is None else eager_ms(fn)
        return t

    lib_rms = getattr(TF, "rms_norm", None)
    for rows in (BATCH, BATCH * PROMPT):
        x, w, _ = inputs(rows, 4096, torch.bfloat16)
        rec["rms_norm"]["shapes"].append(timed(
            rows, 4096, lambda: fused_ops.rms_norm_cuda(x, w, 1e-6),
            lambda: fused_ops._rms_norm_ref(x, w, 1e-6),
            None if lib_rms is None else (
                lambda: lib_rms(x, (4096,), w, 1e-6)),
            _bound(rows, 4096, 2, 1, 4)))
        x, w, b = inputs(rows, 2048, torch.bfloat16)
        rec["layer_norm"]["shapes"].append(timed(
            rows, 2048, lambda: norm.layer_norm_cuda(x, w, b, 1e-5),
            lambda: norm._ln_ref(x, w, b, 1e-5),
            lambda: TF.layer_norm(x, (2048,), w, b, 1e-5),
            _bound(rows, 2048, 2, 2, 8)))
    for name, r in rec.items():
        for s in r["shapes"]:
            print(f"[kernels] {name} {s['rows']}x{s['d']} {s['dtype']}: "
                  f"card ms: kernel {s['ms']:.5f}, plain {s['plain_ms']:.5f}"
                  f", library {s['library_ms']}, bound {s['bound_ms']:.6f} "
                  f"({s['bound_by']}); eager ms per call: kernel "
                  f"{s['eager_ms']:.5f}, plain {s['eager_plain_ms']:.5f}, "
                  f"library {s['eager_library_ms']}")
        print(f"[kernels] {name}: max |kernel - plain| = "
              f"{r['max_abs_err']:.3g} (within tolerance)")
    return rec


_SERVING_MODELS = {}     # family -> model, built once for its two phases


def serving_model(family):
    """The family's full-width serving model (Llama-2-7B or GPT-3 1.3B,
    bf16, random weights from seed 1234), built on first use and kept
    for the family's continuous-batching phase, which releases it."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_1p3b, llama2_7b)

    if family not in _SERVING_MODELS:
        cls, cfg = ((LlamaForCausalLM, llama2_7b()) if family == "llama"
                    else (GPTForCausalLM, gpt3_1p3b()))
        _SERVING_MODELS[family] = cls(cfg, device="cuda", dtype="bfloat16",
                                      generator=seed(1234, "cuda")).eval()
    return _SERVING_MODELS[family]


def _serve(family, kernel):
    """Full-width model through the paged-KV serving path; every norm
    on ``kernel``, one launch per norm (2 a layer + the final one)."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.inference.serving import (
        GenerationSession, get_model_adapter, make_run_model, sample_logits)
    from paddle_tpu_torch.incubate.nn.functional.paged_kv import (
        alloc_block_tables, init_block_cache)
    from paddle_tpu_torch.nn.functional import norm

    torch.cuda.reset_peak_memory_stats()
    model = serving_model(family)
    cfg = model.cfg
    per_forward = 2 * cfg.num_layers + 1
    backbone = model.llama if family == "llama" else model.gpt
    calls = [0]

    def count(_mod, _args):
        calls[0] += 1
    hook = backbone.register_forward_pre_hook(count)

    rs = np.random.RandomState(17)
    ids = rs.randint(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64)
    # ragged prompt lengths 32-128, most off the block boundary
    lens = np.array([PROMPT // 4, PROMPT * 3 // 5, PROMPT * 4 // 5 - 2, PROMPT])
    ragged = rs.randint(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64)
    for r, n in enumerate(lens):
        ragged[r, n:] = 0
    rep = np.tile(ids[:1], (BATCH, 1))
    kw = dict(use_paged_kv=True, kv_block_size=BLOCK)

    for k in (fused_ops.RMS_NORM_KERNEL, norm.LAYER_NORM_KERNEL):
        k.reset_counts()
    calls[0] = 0
    fixed = model.generate(ids, max_new_tokens=NEW, **kw)
    _, t_prefill = sync_time(lambda: model.generate(ids, max_new_tokens=1,
                                                    **kw))
    fixed2, t_full = sync_time(lambda: model.generate(
        ids, max_new_tokens=NEW, **kw))
    sess = GenerationSession(model, batch=BATCH, prompt_len=PROMPT,
                             max_new_tokens=NEW, kv_block_size=BLOCK,
                             ragged_prompts=True)
    gen_ragged = sess.generate(ragged, prompt_lens=lens)
    repeated = model.generate(rep, max_new_tokens=NEW, **kw)
    shared = any(s._shared_plan is not None
                 for s in model._serving_sessions.values())
    # prefill logits of the fixed batch, through the same run_model
    adapter = get_model_adapter(model)
    run = make_run_model(model, adapter)
    bt, nb = alloc_block_tables(BATCH, cfg.max_seq_len, BLOCK,
                                device="cuda")
    pools = [init_block_cache(nb, adapter.kv_heads, BLOCK, adapter.head_dim,
                              adapter.dtype, device="cuda")
             for _ in range(cfg.num_layers)]
    lv, kcs, vcs, seq_lens = run(
        torch.as_tensor(ids, device="cuda"), tuple(p[0] for p in pools),
        tuple(p[1] for p in pools), bt,
        torch.zeros(BATCH, dtype=torch.int32, device="cuda"), 0)
    # one decode step (forward, paged attention, kernels, token
    # selection) must never wait for the card: any host read raises here
    tok = sample_logits(lv, None, False).to(torch.int32)
    torch.cuda.set_sync_debug_mode("error")
    try:
        lv2, *_ = run(tok[:, None], kcs, vcs, bt, seq_lens, seq_lens)
        sample_logits(lv2, None, False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches, plain = kernel.launches, kernel.plain_calls
    other = (norm.LAYER_NORM_KERNEL if kernel is fused_ops.RMS_NORM_KERNEL
             else fused_ops.RMS_NORM_KERNEL)
    n_calls = calls[0]
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    toks = [fixed[:, PROMPT:], gen_ragged, repeated[:, PROMPT:]]
    check(tuple(fixed.shape) == (BATCH, PROMPT + NEW), f"{family} shape")
    check(tuple(gen_ragged.shape) == (BATCH, NEW), f"{family} ragged shape")
    for t in toks:
        check(bool(((t >= 0) & (t < cfg.vocab_size)).all()),
              f"{family}: token out of range")
    check(torch.equal(fixed, fixed2), f"{family}: repeated run differs")
    check(shared, f"{family}: repeated prompt did not take shared prefill")
    check(bool((repeated[:, PROMPT:] == repeated[:1, PROMPT:]).all()),
          f"{family}: greedy rows of a repeated prompt differ")
    check(bool(torch.isfinite(lv).all()) and tuple(lv.shape) == (
        BATCH, cfg.vocab_size), f"{family}: prefill logits not finite")
    check(n_calls > 0 and launches == per_forward * n_calls,
          f"{family}: {launches} kernel launches for {n_calls} forwards "
          f"(want {per_forward} each)")
    check(plain == 0, f"{family}: plain norm ran {plain} times on the card")
    check(other.launches == 0 and other.plain_calls == 0,
          f"{family}: the other norm ran")
    decode_ms = (t_full - t_prefill) / (NEW - 1) * 1e3
    res = dict(forwards=n_calls, launches=launches, plain_calls=plain,
               prefill_ms=t_prefill * 1e3, decode_ms_per_token=decode_ms,
               tokens_per_s=BATCH * NEW / t_full, generate_s=t_full,
               peak_gb=peak_gb,
               params=sum(p.numel() for p in model.parameters()))
    print(f"[{family}] {res['params'] / 1e9:.2f} B params, "
          f"{n_calls} forwards, {launches} {kernel.symbol} launches, "
          f"0 plain; prefill {res['prefill_ms']:.1f} ms "
          f"(B={BATCH}, S={PROMPT}), decode {decode_ms:.2f} ms/token, "
          f"{res['tokens_per_s']:.1f} tokens/s, peak {peak_gb:.1f} GiB")

    # where a decode step goes: the card's time per step (profiler,
    # generate of 9 tokens minus generate of 1) against the host clock
    pre_ms, _ = device_breakdown(lambda: model.generate(
        ids, max_new_tokens=1, **kw))
    all_ms, top = device_breakdown(lambda: model.generate(
        ids, max_new_tokens=9, **kw))
    if pre_ms is not None and all_ms is not None:
        step_ms = (all_ms - pre_ms) / 8
        res.update(prefill_device_ms=pre_ms, decode_device_ms=step_ms,
                   decode_device_busy=step_ms / decode_ms,
                   top_kernels_9_tokens=top)
        print(f"[{family}] card time: prefill {pre_ms:.1f} ms, decode "
              f"{step_ms:.2f} ms/step = {100 * step_ms / decode_ms:.0f}% "
              f"of the host-clock decode step")
        for t in top:
            print(f"[{family}]   {t['ms']:9.2f} ms {t['calls']:6d}x "
                  f"{t['kernel']}")
    else:
        print(f"[{family}] card time: not measured (the profiler recorded "
              f"no device events)")
    hook.remove()
    del model, sess, pools, lv, lv2, kcs, vcs
    torch.cuda.empty_cache()
    return res


def phase_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops

    return _serve("llama", fused_ops.RMS_NORM_KERNEL)


def phase_gpt():
    from paddle_tpu_torch.nn.functional import norm

    return _serve("gpt", norm.LAYER_NORM_KERNEL)


def phase_card_vs_cpu():
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, GenerationSession, Request)
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)

    rs = np.random.RandomState(5)
    ids = rs.randint(1, 1000, (4, 16)).astype(np.int64)
    lens = np.array([5, 16, 11, 8])
    for family, cls, cfg in (("llama", LlamaForCausalLM,
                              llama_tiny(num_kv_heads=2)),
                             ("gpt", GPTForCausalLM, gpt_tiny())):
        cpu = cls(cfg, device="cpu", generator=seed(7, "cpu"))
        gpu = cls(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        for m in (cpu, gpu):
            m.eval()
        for name, run in (
                ("fixed", lambda m: m.generate(
                    ids, max_new_tokens=16, use_paged_kv=True,
                    kv_block_size=8)),
                ("ragged", lambda m: GenerationSession(
                    m, batch=4, prompt_len=16, max_new_tokens=16,
                    kv_block_size=8, ragged_prompts=True).generate(
                        ids, prompt_lens=lens))):
            a, b = run(cpu), run(gpu).cpu()
            check(torch.equal(a, b), f"{family} {name}: card and CPU "
                                     f"greedy streams differ")
        # continuous batching: the card's decode chunks are CUDA graph
        # replays, the CPU's run eagerly
        streams = []
        for m in (cpu, gpu):
            sess = ContinuousBatchingSession(m, slots=2, max_prompt_len=16,
                                             kv_block_size=8, chunk=4)
            for r, n in enumerate(lens):
                sess.submit(Request(r, ids[r, :n], 16))
            streams.append(sess.run())
        check(all(np.array_equal(streams[0][r], streams[1][r])
                  for r in range(len(lens))),
              f"{family} continuous batching: card and CPU greedy streams "
              f"differ")
        print(f"[card-vs-cpu] {family}: greedy streams equal "
              f"(fixed, ragged and continuous batching, fp32)")
        _logprobs_card_vs_cpu(family, cpu, gpu, ids, lens, streams[0])
        _spec_card_vs_cpu(family, cls, cfg, cpu, gpu, ids, lens, streams[0])


# |card - CPU| of a greedy token's log p in fp32 (TF32 off): the two
# devices' GEMMs sum in other orders, so the logits, and the log p
# taken from them, differ by a few fp32 ulps (about 1e-6 at |log p| < 10);
# the bound is 100x that
CARD_LOGPROB_ATOL = 1e-4


def _logprobs_card_vs_cpu(family, cpu, gpu, ids, lens, plain):
    """A greedy logprobs=True continuous session (raw-logits admit graphs
    on the card, each decode step ``chunk`` width-1 replays) gives the
    CPU's streams and the spec-off continuous session's (``plain``), and
    each token's log p within CARD_LOGPROB_ATOL of the CPU's."""
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    runs = []
    for m in (cpu, gpu):
        sess = ContinuousBatchingSession(m, slots=2, max_prompt_len=16,
                                         kv_block_size=8, chunk=4,
                                         logprobs=True)
        reqs = [Request(r, ids[r, :n], 16) for r, n in enumerate(lens)]
        for q in reqs:
            sess.submit(q)
        runs.append((sess.run(), reqs))
        sess._pool.assert_quiescent()
    (c_out, c_reqs), (g_out, g_reqs) = runs
    tag = f"[card-vs-cpu] {family} logprobs"
    check(all(np.array_equal(c_out[r], g_out[r])
              and np.array_equal(g_out[r], plain[r])
              for r in range(len(lens))),
          f"{tag}: streams differ (card, CPU, the device sampler)")
    err = max(float(np.abs(np.subtract(g.token_logprobs,
                                       c.token_logprobs)).max())
              for g, c in zip(g_reqs, c_reqs))
    check(err <= CARD_LOGPROB_ATOL,
          f"{tag}: log p {err:.3g} from the CPU's, bound "
          f"{CARD_LOGPROB_ATOL}")
    print(f"{tag}: greedy streams equal to the CPU's and the device "
          f"sampler's; log p within {err:.3g} of the CPU's (bound "
          f"{CARD_LOGPROB_ATOL})")


def _spec_card_vs_cpu(family, cls, cfg, cpu, gpu, ids, lens, plain):
    """Speculative decoding in fp32 on the card against the CPU: the
    n-gram proposer, a smaller draft of the same family (one layer, other
    weights) and the model as its own draft, greedy, through
    ContinuousBatchingSession (its verify windows and the draft's decode
    step CUDA graphs) and a ragged GenerationSession (its verify widths
    graphs): the card's streams equal the CPU's and the spec-off streams
    (``plain``, the continuous session's) byte for byte, the spec counts
    equal, and the self-draft accepts every draft it proposes."""
    import dataclasses

    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, GenerationSession, Request)
    from paddle_tpu_torch.inference.speculative import SpeculativeConfig

    small_cfg = dataclasses.replace(cfg, num_layers=1)
    small = [cls(small_cfg, device="cpu", generator=seed(11, "cpu"))]
    small.append(cls(small_cfg, device="cuda"))
    small[1].load_state_dict(small[0].state_dict())
    gs_plain = GenerationSession(
        cpu, batch=4, prompt_len=16, max_new_tokens=16, kv_block_size=8,
        ragged_prompts=True).generate(ids, prompt_lens=lens)
    for name, drafts in (("ngram", (None, None)),
                         ("small draft", [m.eval() for m in small]),
                         ("self draft", (cpu, gpu))):
        runs = []
        for m, d in zip((cpu, gpu), drafts):
            spec = SpeculativeConfig(num_draft_tokens=3, **(
                {} if d is None else dict(proposer="draft", draft_model=d)))
            sess = ContinuousBatchingSession(m, slots=2, max_prompt_len=16,
                                             kv_block_size=8,
                                             speculative=spec)
            for r, n in enumerate(lens):
                sess.submit(Request(r, ids[r, :n], 16))
            out = sess.run()
            sess._pool.assert_quiescent()
            gs = GenerationSession(
                m, batch=4, prompt_len=16, max_new_tokens=16,
                kv_block_size=8, ragged_prompts=True, speculative=spec)
            runs.append((out, gs.generate(ids, prompt_lens=lens).cpu(),
                         sess.stats, gs))
        (c_out, c_gs, c_st, _), (g_out, g_gs, g_st, gs) = runs
        tag = f"[card-vs-cpu] {family} spec {name}"
        check(all(gs._verify_ladder.programs[w].graph is not None
                  for w in gs._verify_ladder.programs),
              f"{tag}: a GenerationSession verify width was not captured")
        check(all(np.array_equal(c_out[r], g_out[r])
                  and np.array_equal(g_out[r], plain[r])
                  for r in range(len(lens))),
              f"{tag}: continuous batching streams differ (card, CPU, "
              f"spec off)")
        check(torch.equal(c_gs, g_gs) and torch.equal(g_gs, gs_plain),
              f"{tag}: GenerationSession streams differ (card, CPU, spec "
              f"off)")
        check(c_st == g_st and g_st["spec_proposed_tokens"] > 0,
              f"{tag}: spec counts differ: card {g_st}, CPU {c_st}")
        if name == "self draft":
            check(g_st["spec_accepted_tokens"]
                  == g_st["spec_proposed_tokens"],
                  f"{tag}: the self-draft accepted "
                  f"{g_st['spec_accepted_tokens']} of "
                  f"{g_st['spec_proposed_tokens']} drafts")
        print(f"{tag}: streams equal to the CPU's and spec off's (both "
              f"sessions, fp32); {g_st['spec_steps']} windows, accepted "
              f"{g_st['spec_accepted_tokens']} of "
              f"{g_st['spec_proposed_tokens']} drafts")

# ---------------------------------------------------------------------------
# training slices: K3-K7 and the train steps
# ---------------------------------------------------------------------------

def _check_close(got, ref, name, terms):
    """Max |got - ref| of a kernel output against its plain version's,
    held per element. ``terms`` = (flips, sums), per element (see
    _attention_terms). Every sum is taken in fp32 in another order by the
    kernel than by the plain version, which moves it by far less than
    1e-5 of the magnitudes of all the terms it folds in, through the
    nested sums (``sums``): a dS = p (dP - delta) that cancels to near 0
    keeps the rounding of dP and delta. In bf16, kernel and plain version
    also round the same fp32 quantities to bf16 (p before P.V and dV, ds
    before dK and dQ, the outputs), so a term that lies within that fp32
    difference of a rounding boundary rounds the other way and moves the
    output by one bf16 ulp of the term (at most 2^-7 of it). Such terms
    are rare, so their flips stay far below 2^-8 of the sum of the
    rounded terms' magnitudes (``flips``); one ulp of the output covers
    the final cast. A term dropped or added moves the output by the whole
    term, beyond the tolerance wherever a few terms carry the element
    (the late keys of a causal row)."""
    got, r = got.detach().float(), ref.float()
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs "
                                  f"{tuple(ref.shape)}")
    diff = (got - r).abs()
    tol = _close_tol(ref, terms)
    i = int(torch.argmax(diff - tol))
    check(bool((diff <= tol).all()),
          f"{name}: |kernel - plain| {float(diff.reshape(-1)[i])} > "
          f"{float(tol.reshape(-1)[i])} at element {i} (plain "
          f"{float(r.reshape(-1)[i])}, kernel {float(got.reshape(-1)[i])})")
    return float(diff.max())


def _close_tol(ref, terms):
    """_check_close's tolerance, per element of ``ref``."""
    flips, sums = terms
    tol = 1e-5 * sums
    if ref.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(ref.float()) + 2.0 ** -8 * flips
    return tol


def _attention_terms(q, k, v, out, lse, dout, heads, causal):
    """Per element of out, dq, dk and dv, a pair (flips, sums) of fp32
    tensors of its shape, with p and ds formed as the plain versions form
    them. flips: the sum of the magnitudes of the bf16-rounded terms the
    element sums: sum_k p |v| / l, scale sum_k |ds| |k|,
    scale sum_q |ds| |q| and sum_q p |dO|. sums: the same with |ds|
    replaced by the magnitudes of the terms of ds = p (dO.v - dO.O),
    p (|dO|.|v| + |dO|.|O|). Grouped query: an element of dk or dv sums
    over q rows of every q head that shares its kv head, so its terms
    are summed over that group too (fa._grouped_tn)."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    b, sq, e = q.shape
    sk = k.shape[1]
    kvh = fa._kv_heads(q, k, heads)
    scale = 1.0 / math.sqrt(e // heads)
    qh, doh = fa._heads(q, heads), fa._heads(dout, heads)
    kh, vh = fa._heads(k, kvh), fa._heads(v, kvh)
    qa, ka, va, doa = qh.abs(), kh.abs(), vh.abs(), doh.abs()
    p = torch.exp(fa._masked_logits(qh, kh, causal) - lse.unsqueeze(-1))
    t_out = fa.grouped_pv_out(p, va)
    t_dv = fa._grouped_tn(p, doa, kvh)
    ds = p * (fa.grouped_qk_logits(doh, vh)
              - fa._delta(out, dout, heads).unsqueeze(-1))
    ds = ds.abs()
    f_dq = fa.grouped_pv_out(ds, ka) * scale
    f_dk = fa._grouped_tn(ds, qa, kvh) * scale
    ds = p * (fa.grouped_qk_logits(doa, va)
              + fa._delta(out.abs(), dout.abs(), heads).unsqueeze(-1))
    s_dq = fa.grouped_pv_out(ds, ka) * scale
    s_dk = fa._grouped_tn(ds, qa, kvh) * scale
    del p, ds

    def back(x, s_):
        return x.transpose(1, 2).reshape(b, s_, -1)
    return ((back(t_out, sq),) * 2, (back(f_dq, sq), back(s_dq, sq)),
            (back(f_dk, sk), back(s_dk, sk)), (back(t_dv, sk),) * 2)


def _colsum_within_tol(got, ref, terms):
    """(max |got - ref|, within tolerance, worst |got - ref| / tolerance)
    for dw / db, sums over rows taken in other orders. Tolerance per
    column: 1e-5 of the sum of the terms' magnitudes (fp32 summation
    error) plus one ulp of the output in bf16 or 1e-5 of it in fp32."""
    r = ref.float()
    diff = (got.float() - r).abs()
    own = bf16_ulp(ref) if ref.dtype == torch.bfloat16 else 1e-5 * r.abs()
    ratio = diff / (1e-5 * terms + own)
    ratio = torch.where(torch.isnan(diff), torch.inf, ratio)
    worst = float(ratio.max())
    return float(diff.max()), worst <= 1, worst


def _colsum_err(got, ref, terms, name):
    """_colsum_within_tol, failing the run outside the tolerance."""
    err, ok, worst = _colsum_within_tol(got, ref, terms)
    check(ok, f"{name}: |kernel - plain| / tolerance {worst} (max |kernel "
              f"- plain| {err})")
    return err


# K3's cases (rows, d, weight): the training steps' shape; a ragged row
# count with and without weight on the cp.async-ring kernel (rows of at
# most 512 16-byte vectors); the shared-memory-partials kernel with
# vectors (d = 6144) and without (d = 1001)
LN_BWD_CASES = ((TRAIN_B * TRAIN_S, 2048, True), (77, 2048, True),
                (77, 6144, True), (3, 1001, True), (77, 2048, False))


def ln_bwd_inputs(rows, d, with_w, dt, g):
    """x, w (or None), g for a K3 case, from generator ``g``."""
    x = (torch.randn(rows, d, generator=g, device="cuda") * 2 + 0.5).to(dt)
    w = (torch.randn(d, generator=g, device="cuda").to(dt) if with_w
         else None)
    return x, w, torch.randn(rows, d, generator=g, device="cuda").to(dt)


class _NanAlloc:
    """Stands in for the torch module inside nn/functional/norm.py while
    a check runs K3: its outputs start as NaN, so an element the kernel
    leaves unwritten differs from the plain version."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, **kwargs):
        return torch.empty(*args, **kwargs).fill_(float("nan"))

    @staticmethod
    def empty_like(*args, **kwargs):
        return torch.empty_like(*args, **kwargs).fill_(float("nan"))


def ln_bwd_check(x, w, gy, eps=1e-5):
    """K3 against its plain version on one input, each output held per
    element (dx by max_err_within_tol, dw / db by _colsum_within_tol):
    {"dx" | "dw" | "db": (max |kernel - plain|, within tolerance, worst)};
    worst is dx's worst element or dw / db's worst |kernel - plain| /
    tolerance. Without a weight K3 computes dw all the same (the autograd
    Function drops it), and it is held too."""
    from paddle_tpu_torch.nn.functional import norm

    norm.torch = _NanAlloc()
    try:
        dx, dw, db = norm.layer_norm_bwd_cuda(x, w, gy, eps)
    finally:
        norm.torch = torch
    rdx, rdw, rdb = norm._ln_bwd_ref(x, w, gy, eps)
    res = {"dx": max_err_within_tol(dx, rdx)}
    xf, gf = x.float(), gy.float()
    mean = xf.mean(-1, keepdim=True)
    xhat = (xf - mean) * torch.rsqrt(
        (xf - mean).square().mean(-1, keepdim=True) + eps)
    res["dw"] = _colsum_within_tol(dw, rdw, (gf * xhat).abs().sum(0))
    res["db"] = _colsum_within_tol(db, rdb, gf.abs().sum(0))
    return res


def ln_bwd_same_bytes(x, w, gy, eps=1e-5):
    """Whether two K3 calls on the same inputs give equal dx, dw and db
    bytes (no float atomics: each output has one writer that sums in a
    fixed order)."""
    from paddle_tpu_torch.nn.functional import norm

    first = norm.layer_norm_bwd_cuda(x, w, gy, eps)
    second = norm.layer_norm_bwd_cuda(x, w, gy, eps)
    return all(torch.equal(_bits(a), _bits(b))
               for a, b in zip(first, second))


def _attn_work(b, sq, sk, h, d, causal, kvh=None):
    """(q-k pairs per q head summed over batch and q heads, as the causal
    mask leaves them, and the fwd / bwd FLOPs and bytes at bf16, each
    input read once and each output written once; k, v, dk, dv at the kv
    width of ``kvh`` heads, default h)."""
    off = sk - sq
    if causal:
        pairs = sum(max(0, min(sk, i + off + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    pairs *= b * h
    e, ekv = h * d, (kvh or h) * d
    fwd = dict(flops=4 * pairs * d,
               bytes=(2 * b * sq * e + 2 * b * sk * ekv) * 2 + b * h * sq * 4)
    # in: q, k, v, out, dO, lse; out: dq, dk, dv
    bwd = dict(flops=10 * pairs * d,
               bytes=(4 * b * sq * e + 4 * b * sk * ekv) * 2 + b * h * sq * 4)
    return pairs, fwd, bwd


def _bound_of(work, flops_per_s):
    t_ops = work["flops"] / flops_per_s * 1e3
    t_bytes = work["bytes"] / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _packed(x):
    e = x.shape[-1] // 3
    return x[..., :e], x[..., e:2 * e], x[..., 2 * e:]


def _check_attention(name, b, sq, sk, h, d, causal, dt, g, packed,
                     kvh=None):
    """Kernel forward and backward against the plain versions, batch
    element by batch element (the plain version at B=1 bounds memory);
    then a second backward on the same inputs must give the same bytes.
    ``kvh``: kv heads of the unpacked k, v (default h)."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    e, ekv = h * d, (kvh or h) * d
    if packed:
        qkv = torch.randn(b, sq, 3 * e, generator=g, device="cuda").to(dt)
        q, k, v = _packed(qkv)
        grads = torch.empty_like(qkv)
        dq, dk, dv = _packed(grads)
    else:
        q = torch.randn(b, sq, e, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(b, sk, ekv, generator=g, device="cuda").to(dt)
                for _ in range(2))
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
    dout = torch.randn(b, sq, e, generator=g, device="cuda").to(dt)
    out, lse = fa.flash_fwd_cuda(q, k, v, h, causal)
    _same_forward_bytes(name, (out, lse), fa.flash_fwd_cuda(q, k, v, h,
                                                            causal))
    fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, causal, dq, dk, dv)
    again = [torch.full_like(x, float("nan")) for x in (dq, dk, dv)]
    fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, causal, *again)
    torch.cuda.synchronize()
    for key, x, y in zip(("dq", "dk", "dv"), (dq, dk, dv), again):
        check(torch.equal(x, y), f"{name} {key}: two backward calls on the "
                                 f"same inputs differ")
    del again
    errs = dict(out=0.0, lse=0.0, dq=0.0, dk=0.0, dv=0.0)
    for i in range(b):
        sl = slice(i, i + 1)
        rout, rlse = fa._nl_forward_ref(q[sl], k[sl], v[sl], h, causal)
        rdq, rdk, rdv = fa._nl_backward_ref(q[sl], k[sl], v[sl], out[sl],
                                            lse[sl], dout[sl], h, causal)
        terms = _attention_terms(q[sl], k[sl], v[sl], out[sl], lse[sl],
                                 dout[sl], h, causal)
        for key, got, ref, t_ in zip(
                ("out", "dq", "dk", "dv"), (out[sl], dq[sl], dk[sl], dv[sl]),
                (rout, rdq, rdk, rdv), terms):
            errs[key] = max(errs[key], _check_close(
                got, ref, f"{name} {key} (batch {i})", t_))
        # lse: fp32 statistics of sums in other orders
        ld = float((lse[sl] - rlse).abs().max())
        check(ld <= 1e-5 * max(1.0, float(rlse.abs().max())),
              f"{name} lse (batch {i}): max err {ld}")
        errs["lse"] = max(errs["lse"], ld)
    print(f"[train_kernels] {name}: max |kernel - plain| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + "; out, lse and dq, dk, dv byte-identical over two forward and "
            "two backward calls")
    return errs


def _same_forward_bytes(name, first, second):
    """Two forward calls on the same inputs: out and lse byte-identical
    (each element has one writer)."""
    torch.cuda.synchronize()
    for key, x, y in zip(("out", "lse"), first, second):
        check(torch.equal(x.view(torch.int8), y.view(torch.int8)),
              f"{name} {key}: two forward calls on the same inputs differ")


def _check_attention_fwd(name, b, sq, sk, h, d, dt, g, kvh):
    """K4 alone (a dense decode step has no backward) against its plain
    version, per element, on [B, Sq, H*D] q and [B, Sk, KVH*D] k, v,
    causal aligned bottom-right; out and lse, and two calls give the
    same bytes."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    q = torch.randn(b, sq, h * d, generator=g, device="cuda").to(dt)
    k, v = (torch.randn(b, sk, kvh * d, generator=g, device="cuda").to(dt)
            for _ in range(2))
    out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
    _same_forward_bytes(name, (out, lse), fa.flash_fwd_cuda(q, k, v, h,
                                                            True))
    rout, rlse = fa._nl_forward_ref(q, k, v, h, True)
    terms = _attention_terms(q, k, v, rout, rlse, torch.zeros_like(q), h,
                             True)[0]
    err = _check_close(out, rout, f"{name} out", terms)
    ld = float((lse - rlse).abs().max())
    check(ld <= 1e-5 * max(1.0, float(rlse.abs().max())),
          f"{name} lse: max err {ld}")
    return dict(out=err, lse=ld)


# K4 at one query row (a dense decode step): (B, Sk, H, KVH, D) at which
# its card time is measured. Llama-2-7B's heads (32 of d=128) and
# TinyLlama's 32:4 at d=64, both at B=4, the serving phases' batch
DECODE_SHAPES = [(BATCH, sk, 32, 32, 128) for sk in (1, 512, 4096)] + [
    (BATCH, sk, 32, 4, 64) for sk in (1, 512, 4096)]


def _time_decode(b, sk, h, kvh, d, g):
    """Card ms of K4 at one causal query row against Sk keys, bf16,
    beside the bound, the plain version and sdpa's forward at the same
    shape ([B,H,1,D] against [B,KVH,Sk,D], enable_gqa when KVH < H,
    is_causal=False: sdpa aligns its causal mask top-left, and one
    bottom-right-aligned row sees every key)."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    bf = torch.bfloat16
    q = torch.randn(b, 1, h * d, generator=g, device="cuda").to(bf)
    k, v = (torch.randn(b, sk, kvh * d, generator=g, device="cuda").to(bf)
            for _ in range(2))
    qh = q.reshape(b, 1, h, d).transpose(1, 2)
    kh, vh = (x.reshape(b, sk, kvh, d).transpose(1, 2) for x in (k, v))
    pairs, fwd, _ = _attn_work(b, 1, sk, h, d, True, kvh)
    t = dict(shape=f"B={b} Sq=1 Sk={sk} H={h} KVH={kvh} D={d} causal bf16",
             pairs=pairs)
    return _timings(
        t, fwd, partial(fa.flash_fwd_cuda, q, k, v, h, True),
        partial(fa._nl_forward_ref, q, k, v, h, True),
        {"sdpa": partial(TF.scaled_dot_product_attention, qh, kh, vh,
                         enable_gqa=kvh != h)})


def _no_repeat_memory(g):
    """The north star's no-K/V-repeat contract on the card, at TinyLlama's
    32:4 (B=8, S=2048, D=64, bf16, causal): the rise of allocated memory
    over one forward and backward through the autograd Function must stay
    below the tensors it may hold (out, lse, dq, delta, dk and dv at the kv
    width) plus one [B,S,H*D] bf16 tensor; a repeat of k and v to the q
    heads would add two such tensors."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    b, s, h, kvh, d = TRAIN_LLAMA_B, TRAIN_S, 32, 4, 64
    q = torch.randn(b, s, h * d, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, s, kvh * d, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_() for _ in range(2))
    gout = torch.randn(b, s, h * d, generator=g, device="cuda").to(
        torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fa._flash_nl(q, k, v, True, h)
    out.backward(gout)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    full = b * s * h * d * 2                    # one [B,S,H*D] bf16 tensor
    stats = b * h * s * 4                       # one fp32 [B,H,S] tensor
    allowed = 2 * full + 2 * stats + 2 * (b * s * kvh * d * 2)
    check(k.grad.shape == k.shape and v.grad.shape == v.shape,
          "no-repeat: dk, dv are not at the kv width")
    check(rise <= allowed + full,
          f"no-repeat: memory rose by {rise} bytes over a 32:4 forward and "
          f"backward, above {allowed} allowed + {full}")
    print(f"[train_kernels] no K/V repeat at 32:4 (B={b}, S={s}): memory "
          f"rose by {rise / 2**20:.1f} MiB over one forward and backward; "
          f"out + lse + dq + delta + dk + dv take {allowed / 2**20:.1f} MiB, "
          f"the bound is {(allowed + full) / 2**20:.1f} MiB (a repeat of k "
          f"and v would add {2 * full / 2**20:.1f})")
    res = dict(rise_bytes=rise, allowed_bytes=allowed, bound_bytes=allowed
               + full)
    del q, k, v, gout, out
    torch.cuda.empty_cache()
    return res


def _time_attention(which, b, h, kvh, d, g):
    """Card ms of K4 ("fwd") or K5 ("bwd") at [B, 2048, H*D] q and
    [B, 2048, KVH*D] k, v (packed [B,S,3E] when KVH == H, as GPT's step
    passes them), causal bf16, beside the bound, the plain version and
    the library: sdpa forward (enable_gqa when KVH < H), or the backward
    op alone of sdpa's flash and cuDNN backends on the outputs their
    forward op saved, as sdpa's autograd calls it (the faster of the two
    is the yardstick); both take the KVH kv heads as they are."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    s = TRAIN_S
    e, ekv = h * d, kvh * d
    if kvh == h:
        qkv = torch.randn(b, s, 3 * e, generator=g, device="cuda").to(
            torch.bfloat16)
        q, k, v = _packed(qkv)
        grads = _packed(torch.empty_like(qkv))
    else:
        q = torch.randn(b, s, e, generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(b, s, ekv, generator=g, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
    dout = torch.randn(b, s, e, generator=g, device="cuda").to(torch.bfloat16)
    out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
    pairs, fwd_work, bwd_work = _attn_work(b, s, s, h, d, True, kvh)

    def heads(t_, n):
        return t_.reshape(b, s, n, d).transpose(1, 2)
    qh, kh, vh, dout_h = (heads(q, h), heads(k, kvh), heads(v, kvh),
                          heads(dout, h))
    t = dict(shape=f"B={b} S={s} H={h} KVH={kvh} D={d} causal bf16",
             pairs=pairs)
    if which == "fwd":
        work = fwd_work
        kern = partial(fa.flash_fwd_cuda, q, k, v, h, True)
        plain = partial(fa._nl_forward_ref, q, k, v, h, True)
    else:
        work = bwd_work
        kern = partial(fa.flash_bwd_cuda, q, k, v, out, lse, dout, h, True,
                       *grads)
        plain = partial(fa._nl_backward_ref, q, k, v, out, lse, dout, h, True)
    return _timings(t, work, kern, plain,
                    _library_attention(which, qh, kh, vh, dout_h))


def _library_attention(which, qh, kh, vh, dout_h):
    """{name: one PyTorch call} computing the same function on [B,H,S,D]
    q and [B,KVH,S,D] k, v (causal): sdpa's forward (enable_gqa when KVH
    < H), or the backward op alone of sdpa's flash and cuDNN backends on
    the outputs their forward op saved, as sdpa's autograd calls it."""
    import torch.nn.functional as TF

    aten = torch.ops.aten
    if which == "fwd":
        return {"sdpa": partial(TF.scaled_dot_product_attention, qh, kh, vh,
                                is_causal=True,
                                enable_gqa=kh.shape[1] != qh.shape[1])}
    fo = aten._scaled_dot_product_flash_attention(qh, kh, vh, 0.0, True)
    co = aten._scaled_dot_product_cudnn_attention(qh, kh, vh, None, True,
                                                  0.0, True)
    return {"flash backward": partial(
                aten._scaled_dot_product_flash_attention_backward, dout_h,
                qh, kh, vh, *fo[:6], 0.0, True, fo[6], fo[7]),
            "cudnn backward": partial(
                aten._scaled_dot_product_cudnn_attention_backward, dout_h,
                qh, kh, vh, co[0], co[1], co[6], co[7], None, *co[2:6],
                0.0, True)}


def _timings(t, work, kern, plain, lib):
    """t with the work, its bound and the card ms (CUDA graph) of the
    kernel, its plain version and the library calls (the fastest is the
    yardstick)."""
    t.update(flops=work["flops"], bytes=work["bytes"])
    t["bound_ms"], t["bound_by"] = _bound_of(work, BF16_FLOPS)
    t["ms"] = device_ms(kern, iters=10, reps=7)
    t["plain_ms"] = device_ms(plain, iters=2, reps=3)
    t["library_ms_by_op"] = {n: device_ms(f, iters=10, reps=7)
                             for n, f in lib.items()}
    t["library_ms"] = min(t["library_ms_by_op"].values())
    return t


def _time_attention_hm(which, b, h, d, g, s=TRAIN_S, split=None):
    """Card ms of K6 ("fwd") or the head-major backward ("bwd": K8 with
    ``split``, else K7; default: K8 where Sq*D*4 passes the one-pass
    budget, as the dispatch picks it) at head-major [B*H, S, D] q, k, v
    (contiguous, as fused_self_attention and the flag-0 route pass them;
    grouped k, v come repeated to the H heads), causal bf16, beside the
    bound, the plain version and the library calls on the same memory
    viewed [B,H,S,D]. The plain version runs on as many heads at a time
    as keep its [heads,S,S] fp32 products within 4 GiB."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    if split is None:
        split = s * d * 4 > fa._DQ_SCRATCH_BYTES
    bwd, bwd_ref, kname = _hm_backward(split)
    q, k, v, dout = (torch.randn(b * h, s, d, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(4))
    out, lse = fa.flash_fwd_hm_cuda(q, k, v, True)
    pairs, fwd_work, bwd_work = _attn_work(b, s, s, h, d, True)
    t = dict(shape=f"G=B*H={b}*{h} S={s} D={d} causal bf16 head-major",
             pairs=pairs)
    step = max(1, 2 ** 32 // (s * s * 4))

    def chunked(fn, *xs):
        return [fn(*(x[i:i + step] for x in xs), True)
                for i in range(0, b * h, step)]
    if which == "fwd":
        work = fwd_work
        kern = partial(fa.flash_fwd_hm_cuda, q, k, v, True)
        plain = partial(chunked, fa._hm_forward_ref, q, k, v)
    else:
        t["kernel"] = kname
        work = bwd_work
        kern = partial(bwd, q, k, v, out, lse, dout, True)
        plain = partial(chunked, bwd_ref, q, k, v, out, lse, dout)
    return _timings(t, work, kern, plain, _library_attention(
        which, *(x.view(b, h, s, d) for x in (q, k, v, dout))))


def _hm_backward(split):
    """(kernel wrapper, plain version, name) of the head-major backward:
    K8 with ``split``, else K7."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    if split:
        return fa.flash_bwd_hm_split_cuda, fa._hm_backward_split_ref, "K8"
    return fa.flash_bwd_hm_cuda, fa._hm_backward_ref, "K7"


def _check_attention_hm(name, groups, sq, sk, d, causal, dt, g, chunk=16,
                        strided=False, split=False):
    """K6 and the head-major backward (K7, or K8 with ``split``)
    against their plain versions at head-major [G,Sq,D] q and [G,Sk,D] k,
    v, ``chunk`` heads at a time (the plain version's [G,S,S] products
    bound memory); two backward calls on the same inputs must give the
    same bytes. ``strided`` (Sq == Sk): q, k, v are views of one
    [S,3,G,D] buffer (group stride D, row stride 3GD), as the fused op's
    projection gives them at B=1."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    bwd, bwd_ref, kname = _hm_backward(split)
    dout = torch.randn(groups, sq, d, generator=g, device="cuda").to(dt)
    if strided:
        buf = torch.randn(sq, 3, groups, d, generator=g, device="cuda").to(dt)
        q, k, v = (buf[:, i].transpose(0, 1) for i in range(3))
    else:
        q = torch.randn(groups, sq, d, generator=g, device="cuda").to(dt)
        k, v = (torch.randn(groups, sk, d, generator=g, device="cuda").to(dt)
                for _ in range(2))
    out, lse = fa.flash_fwd_hm_cuda(q, k, v, causal)
    _same_forward_bytes(name, (out, lse), fa.flash_fwd_hm_cuda(q, k, v,
                                                               causal))
    grads = bwd(q, k, v, out, lse, dout, causal)
    again = bwd(q, k, v, out, lse, dout, causal)
    torch.cuda.synchronize()
    for key, x, y in zip(("dq", "dk", "dv"), grads, again):
        check(torch.equal(x, y), f"{name} {key}: two {kname} calls on the "
                                 f"same inputs differ")
    del again
    errs = dict(out=0.0, lse=0.0, dq=0.0, dk=0.0, dv=0.0)
    for i in range(0, groups, chunk):
        sl = slice(i, min(groups, i + chunk))
        rout, rlse = fa._hm_forward_ref(q[sl], k[sl], v[sl], causal)
        rgrads = bwd_ref(q[sl], k[sl], v[sl], out[sl], lse[sl], dout[sl],
                         causal)
        terms = _attention_terms(q[sl], k[sl], v[sl], out[sl],
                                 lse[sl].unsqueeze(1), dout[sl], 1, causal)
        for key, got, ref, t_ in zip(
                ("out", "dq", "dk", "dv"), (out[sl],) + tuple(
                    x[sl] for x in grads), (rout,) + tuple(rgrads), terms):
            errs[key] = max(errs[key], _check_close(
                got, ref, f"{name} {key} (heads {sl.start}-{sl.stop - 1})",
                t_))
        ld = float((lse[sl] - rlse).abs().max())
        check(ld <= 1e-5 * max(1.0, float(rlse.abs().max())),
              f"{name} lse (heads {sl.start}-{sl.stop - 1}): max err {ld}")
        errs["lse"] = max(errs["lse"], ld)
    print(f"[train_kernels] {name}: max |kernel - plain| "
          + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
          + f"; out, lse byte-identical over two K6 calls, dq, dk, dv "
            f"over two {kname} calls")
    return errs


def _check_k8_against_k7(groups, s, d, causal, dt, g, chunk):
    """K8 and K7 on the same head-major inputs (S at most K7's budget):
    their dq, dk and dv must agree within _check_close's per-element
    tolerance, ``chunk`` heads at a time."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    name = (f"K8 vs K7 G={groups} S={s} D={d} {str(dt)[6:]} "
            f"causal={causal}")
    q, k, v, dout = (torch.randn(groups, s, d, generator=g,
                                 device="cuda").to(dt) for _ in range(4))
    out, lse = fa.flash_fwd_hm_cuda(q, k, v, causal)
    k7 = fa.flash_bwd_hm_cuda(q, k, v, out, lse, dout, causal)
    k8 = fa.flash_bwd_hm_split_cuda(q, k, v, out, lse, dout, causal)
    errs = dict(dq=0.0, dk=0.0, dv=0.0)
    for i in range(0, groups, chunk):
        sl = slice(i, min(groups, i + chunk))
        terms = _attention_terms(q[sl], k[sl], v[sl], out[sl],
                                 lse[sl].unsqueeze(1), dout[sl], 1, causal)
        for key, a, b, t_ in zip(("dq", "dk", "dv"), k8, k7, terms[1:]):
            errs[key] = max(errs[key], _check_close(
                a[sl], b[sl], f"{name} {key} (heads {sl.start}-"
                              f"{sl.stop - 1})", t_))
    print(f"[train_kernels] {name}: max |K8 - K7| "
          + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in errs.items())
          + " (within the per-element tolerance)")
    return errs


def graph_kernels(fn, tag):
    """The kernels one fn() launches: {mangled name: grid}, read from the
    nodes of a CUDA graph that captures fn() (graph_kernel_nodes)."""
    return dict(graph_kernel_nodes(fn, tag))


def graph_kernel_nodes(fn, tag):
    """Every kernel node of a CUDA graph that captures fn(), in order:
    [(mangled name, grid)], from cudaGraphDebugDotPrint (written under
    build/graphs/). Unlike the profiler, which on the card at times
    records none or only part of a session's kernels, the graph holds
    every launch."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)   # kept for the dump
    graph.enable_debug_mode()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    nodes = dumped_kernel_nodes(graph, tag)
    del graph
    return nodes


def dumped_kernel_nodes(graph, tag):
    """[(mangled name, grid)] of every kernel node of ``graph`` (made with
    keep_graph=True and enable_debug_mode), from its
    cudaGraphDebugDotPrint."""
    import re
    import warnings

    path = REPO / "build" / "graphs" / f"{tag.replace(' ', '_')}.dot"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # its "DEBUG: ..." notes
        graph.debug_dump(str(path))
    check(path.exists(), f"{tag}: no CUDA graph dump at {path}")
    # a kernel node reads "<name>\<\<\<\{x,y\},threads,smem\>\>\>"
    # (or a single x)
    nodes = re.findall(r"(_Z\w+)\\<\\<\\<(?:\\\{([\d,]+)\\\}|(\d+)),",
                       path.read_text())
    return [(name, tuple(int(x) for x in (grid or one).split(",")))
            for name, grid, one in nodes]


def _grid3(grid):
    """A CUDA graph node's grid as (x, y, z): the dump leaves out
    trailing dimensions of 1."""
    return tuple(grid) + (1,) * (3 - len(grid))


def _flash_routes(g):
    """Which kernels a K4, K5 and K6 call launch, read from a CUDA graph
    of one call (graph_kernels): in bf16 the warpgroup kernels (K4 and K6:
    csrc/flash_fwd_sm90.cu's forward, grid (ceil(Sq/128), H, B), head-major
    (ceil(Sq/128), 1, G); K5: csrc/flash_bwd_sm90.cu's delta, kv kernel
    without dq, grid (ceil(Sk/128), KVH, B), and dq kernel, grid
    (ceil(Sq/128), H, B)), at TinyLlama's 32:4 (native) and GPT-3 1.3B's
    head-major shape; in fp32 (small shapes) the earlier kernels of
    csrc/flash_fwd.cu and csrc/flash_bwd.cu. Three calls each must count
    three launches on the expected entry point, built from the expected
    source, and none on the other five; the graph must hold exactly the
    expected kernels."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    entries = (fa.FLASH_FWD_KERNEL, fa.FLASH_FWD_FP32_KERNEL,
               fa.FLASH_FWD_HM_KERNEL, fa.FLASH_FWD_HM_FP32_KERNEL,
               fa.FLASH_BWD_KERNEL, fa.FLASH_BWD_FP32_KERNEL)
    bf, f32 = torch.bfloat16, torch.float32
    b, s, h, kvh, d = TRAIN_LLAMA_B, TRAIN_S, 32, 4, 64
    nq = -(-s // 128)
    # (tag, dtype, shape (B, S, H, KVH, D) or head-major (G, S, D), entry,
    # source, {kernel fragment: grid or None})
    cases = [
        ("K4 bf16", bf, (b, s, h, kvh, d), entries[0], "flash_fwd_sm90.cu",
         {"fwd_kernelILi64E": (nq, h, b)}),
        ("K5 bf16", bf, (b, s, h, kvh, d), entries[4], "flash_bwd_sm90.cu",
         {"delta_kernelI13__nv_bfloat16Li64E": None,
          "bwd_kv_kernelILi64ELb0E": (nq, kvh, b),
          "bwd_dq_kernelILi64E": (nq, h, b)}),
        ("K6 bf16", bf, (TRAIN_B * 16, s, 128), entries[2],
         "flash_fwd_sm90.cu", {"fwd_kernelILi128E": (nq, 1, TRAIN_B * 16)}),
        ("K4 fp32", f32, (1, 256, 4, 2, 64), entries[1], "flash_fwd.cu",
         {"flash_fwd_kernelIfLi64E": None}),
        ("K5 fp32", f32, (1, 256, 4, 2, 64), entries[5], "flash_bwd.cu",
         {"delta_kernelIfLi64E": None, "flash_dkdv_kernelIfLi64E": None,
          "flash_dq_kernelIfLi64E": None}),
        ("K6 fp32", f32, (16, 256, 128), entries[3], "flash_fwd.cu",
         {"flash_fwd_kernelIfLi128E": None})]
    out = {}
    for tag, dt, shape, entry, source, kernels in cases:
        check(entry.source.name == source,
              f"{tag}: {entry.symbol} is built from {entry.source.name}, "
              f"want {source}")
        if len(shape) == 3:
            q, k, v = (torch.randn(*shape, generator=g, device="cuda").to(dt)
                       for _ in range(3))
            call = partial(fa.flash_fwd_hm_cuda, q, k, v, True)
        else:
            b_, s_, h_, kvh_, d_ = shape
            q, dout = (torch.randn(b_, s_, h_ * d_, generator=g,
                                   device="cuda").to(dt) for _ in range(2))
            k, v = (torch.randn(b_, s_, kvh_ * d_, generator=g,
                                device="cuda").to(dt) for _ in range(2))
            call = partial(fa.flash_fwd_cuda, q, k, v, h_, True)
            if tag.startswith("K5"):
                o, lse = call()
                grads = [torch.empty_like(x) for x in (q, k, v)]
                call = partial(fa.flash_bwd_cuda, q, k, v, o, lse, dout, h_,
                               True, *grads)
        call()
        torch.cuda.synchronize()
        for e in entries:
            e.reset_counts()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        counts = {e.symbol: e.launches for e in entries}
        check(counts == {e.symbol: 3 if e is entry else 0 for e in entries},
              f"{tag}: launches by entry point {counts}, want 3 on "
              f"{entry.symbol} only")
        nodes = graph_kernels(call, tag)
        for kern in kernels:
            check(sum(kern in n for n in nodes) == 1,
                  f"{tag}: {kern} is not once among the kernels of its "
                  f"CUDA graph {nodes}")
        others = [n for n in nodes if not any(kern in n for kern in kernels)]
        check(not others, f"{tag}: other kernels launched: {others}")
        grids = {kern: _grid3(next(grid for n, grid in nodes.items()
                                   if kern in n)) for kern in kernels}
        for kern, want in kernels.items():
            check(want is None or grids[kern] == want,
                  f"{tag}: {kern}'s grid is {grids[kern]}, want {want}")
        out[tag] = dict(entry=entry.symbol, source=source,
                        kernels=list(nodes), grids=grids)
        print(f"[train_kernels] {tag} {shape}: 3 calls, 3 launches of "
              f"{entry.symbol} ({source}); one call's CUDA graph: "
              + ", ".join(f"{kern} grid {grid}"
                          for kern, grid in grids.items()))
        del q, k, v
    return out


def _hm_backward_routes(g):
    """Which kernels a K7 and a K8 call launch: in bf16 (GPT-3 1.3B's 2K
    shape) the warpgroup kernels of csrc/flash_bwd_sm90.cu (K7: the kv
    kernel with dq; K8: the kv kernel without it, then the dq kernel), in
    fp32 (G=16, S=1024) the earlier kernels. Three calls each must count
    three launches on the expected entry point, whose library is built
    from the expected source, and none on the other three; and one call
    captured in a CUDA graph must hold the expected kernels after the
    delta kernel, and nothing else but the zeroing of K7's counters."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    entries = (fa.FLASH_BWD_HM_KERNEL, fa.FLASH_BWD_HM_FP32_KERNEL,
               fa.FLASH_BWD_HM_SPLIT_KERNEL, fa.FLASH_BWD_HM_SPLIT_FP32_KERNEL)
    # mangled-name fragments of the kernels each call launches
    want = {("K7", torch.bfloat16): (entries[0], "flash_bwd_sm90.cu",
                                     ("bwd_kv_kernelILi128ELb1E",)),
            ("K8", torch.bfloat16): (entries[2], "flash_bwd_sm90.cu",
                                     ("bwd_kv_kernelILi128ELb0E",
                                      "bwd_dq_kernelILi128E")),
            ("K7", torch.float32): (entries[1], "flash_bwd_hm.cu",
                                    ("flash_bwd_hm_kernelIfLi128E",)),
            ("K8", torch.float32): (entries[3], "flash_bwd.cu",
                                    ("flash_dkdv_kernelIfLi128E",
                                     "flash_dq_kernelIfLi128E"))}
    out = {}
    for (kname, dt), (entry, source, kernels) in want.items():
        tag = f"{kname} {str(dt)[6:]}"
        check(entry.source.name == source,
              f"{tag}: {entry.symbol} is built from {entry.source.name}, "
              f"want {source}")
        groups, s_ = (TRAIN_B * 16, TRAIN_S) if dt == torch.bfloat16 else \
            (16, 1024)
        q, k, v, dout = (torch.randn(groups, s_, 128, generator=g,
                                     device="cuda").to(dt) for _ in range(4))
        o, lse = fa.flash_fwd_hm_cuda(q, k, v, True)
        bwd = (fa.flash_bwd_hm_cuda if kname == "K7"
               else fa.flash_bwd_hm_split_cuda)
        bwd(q, k, v, o, lse, dout, True)
        torch.cuda.synchronize()
        for e in entries:
            e.reset_counts()
        for _ in range(3):
            bwd(q, k, v, o, lse, dout, True)
        torch.cuda.synchronize()
        counts = {e.symbol: e.launches for e in entries}
        check(counts == {e.symbol: 3 if e is entry else 0 for e in entries},
              f"{tag}: launches by entry point {counts}, want 3 on "
              f"{entry.symbol} only")
        nodes = graph_kernels(lambda: bwd(q, k, v, o, lse, dout, True), tag)
        expected = kernels + ("delta_kernelI",)
        for kern in expected:
            check(sum(kern in n for n in nodes) == 1,
                  f"{tag}: {kern} is not once among the kernels of its "
                  f"CUDA graph {nodes}")
        others = [n for n in nodes
                  if not any(kern in n for kern in expected)]
        check(all("FillFunctor" in n for n in others),
              f"{tag}: other kernels launched: {others}")
        grids = {kern: next(grid for n, grid in nodes.items() if kern in n)
                 for kern in expected}
        if dt == torch.bfloat16:
            # the kv kernel: one CTA per (kv tile of 128, head), the heads
            # in the batch place
            want_grid = (-(-s_ // 128), 1, groups)
            check(_grid3(grids[kernels[0]]) == want_grid,
                  f"{tag}: the kv kernel's grid is {grids[kernels[0]]}, "
                  f"want {want_grid}")
        out[tag] = dict(entry=entry.symbol, source=source,
                        kernels=list(nodes), grids=grids)
        print(f"[train_kernels] {tag} (G={groups}, S={s_}, D=128): 3 calls, "
              f"3 launches of {entry.symbol} ({source}); one call's CUDA "
              f"graph: " + ", ".join(f"{kern} grid {grid}"
                                     for kern, grid in grids.items())
              + (f", {len(others)} counter fill" if others else ""))
        del q, k, v, dout, o, lse
    return out


def phase_train_kernels():
    """K3-K7 against their plain versions on the card, gradients
    through the K1 / K2 Functions, and the timing table at the training
    step's shapes."""
    import torch.nn.functional as TF

    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    g = torch.Generator(device="cuda").manual_seed(3)
    rec = {"layer_norm_bwd": {"max_abs_err": 0.0},
           "flash_fwd": {"max_abs_err": 0.0},
           "flash_bwd": {"max_abs_err": 0.0},
           "flash_fwd_gqa": {"max_abs_err": 0.0},
           "flash_bwd_gqa": {"max_abs_err": 0.0},
           "flash_fwd_hm": {"max_abs_err": 0.0},
           "flash_bwd_hm": {"max_abs_err": 0.0},
           "flash_fwd_hm_ramp": {"max_abs_err": 0.0},
           "flash_bwd_hm_ramp": {"max_abs_err": 0.0},
           "flash_fwd_hm_long": {"max_abs_err": 0.0},
           "flash_bwd_hm_split": {"max_abs_err": 0.0},
           "k8_vs_k7": {"max_abs_err": 0.0}, "autograd": {}}
    rows = TRAIN_B * TRAIN_S

    # K3: every case of LN_BWD_CASES in bf16 and fp32, each output held
    # per element; two calls at the step's shape give the same bytes
    for dt in (torch.bfloat16, torch.float32):
        for r, d, with_w in LN_BWD_CASES:
            res = ln_bwd_check(*ln_bwd_inputs(r, d, with_w, dt, g))
            for name, (err, ok, worst) in res.items():
                check(ok, f"layer_norm_bwd {name} {r}x{d} {dt} weight="
                          f"{with_w}: max err {err}, worst |kernel - plain|"
                          f" / tolerance {worst}")
                rec["layer_norm_bwd"]["max_abs_err"] = max(
                    rec["layer_norm_bwd"]["max_abs_err"], err)
    check(ln_bwd_same_bytes(*ln_bwd_inputs(rows, 2048, True, torch.bfloat16,
                                           g)),
          "layer_norm_bwd: two calls gave different dx, dw or db bytes")
    print(f"[train_kernels] layer_norm_bwd: max |kernel - plain| = "
          f"{rec['layer_norm_bwd']['max_abs_err']:.3g} (within tolerance) "
          f"at {len(LN_BWD_CASES)} cases in bf16 and fp32; two calls at "
          f"[{rows}, 2048] bf16 give the same dx, dw and db bytes")

    # the K1 / K2 autograd Functions on the card, at the step's shape:
    # forward output and gradients
    for dt in (torch.bfloat16, torch.float32):
        x = (torch.randn(rows, 2048, generator=g, device="cuda") * 2 + 0.5
             ).to(dt).requires_grad_()
        w = torch.randn(2048, generator=g, device="cuda").to(
            dt).requires_grad_()
        b = torch.randn(2048, generator=g, device="cuda").to(
            dt).requires_grad_()
        gy = torch.randn(rows, 2048, generator=g, device="cuda").to(dt)
        y = norm.layer_norm(x, 2048, w, b)
        err, ok, worst = max_err_within_tol(
            y, norm._ln_ref(x.detach(), w.detach(), b.detach(), 1e-5))
        check(ok, f"layer_norm {dt}: forward differs from the plain "
                  f"version's: {err}, worst element {worst}")
        y.backward(gy)
        check(x.grad is not None and w.grad is not None
              and b.grad is not None, f"layer_norm {dt}: a gradient is "
                                      f"missing on the card")
        xd, wd = x.detach(), w.detach()
        rdx, rdw, rdb = norm._ln_bwd_ref(xd, wd, gy, 1e-5)
        err, ok, worst = max_err_within_tol(x.grad, rdx)
        check(ok, f"layer_norm {dt}: x.grad differs from the plain "
                  f"version's: {err}, worst element {worst}")
        xf, gf = xd.float(), gy.float()
        mean = xf.mean(-1, keepdim=True)
        xhat = (xf - mean) * torch.rsqrt(
            (xf - mean).square().mean(-1, keepdim=True) + 1e-5)
        _colsum_err(w.grad, rdw, (gf * xhat).abs().sum(0),
                    f"layer_norm {dt}: w.grad")
        _colsum_err(b.grad, rdb, gf.abs().sum(0), f"layer_norm {dt}: b.grad")
        xr = x.detach().clone().requires_grad_()
        wr = w.detach().clone().requires_grad_()
        y = fused_ops.fused_rms_norm(xr, wr, epsilon=1e-6)
        err, ok, _ = max_err_within_tol(
            y, fused_ops._rms_norm_ref(xr.detach(), wr.detach(), 1e-6))
        check(ok, f"rms_norm {dt}: forward differs from plain ({err})")
        y.backward(gy)
        check(xr.grad is not None and wr.grad is not None,
              f"rms_norm {dt}: a gradient is missing on the card")
        rdx, rdw = fused_ops._rms_norm_vjp(xr.detach(), wr.detach(), gy,
                                           1e-6)
        check(torch.equal(xr.grad, rdx) and torch.equal(wr.grad, rdw),
              f"rms_norm {dt}: gradients differ from the plain VJP's")
        rec["autograd"][str(dt)] = ("forward and x/w/b grads equal to "
                                    "plain")
    print(f"[train_kernels] K1/K2 Functions at [{rows}, 2048]: forward "
          f"and x, w, b gradients set on the card and equal to the plain "
          f"versions' (bf16, fp32)")

    # K4 / K5: the GPT and TinyLlama steps' shapes, ragged and fp32 ones,
    # unpacked with Sk > Sq, and grouped query (KVH < H: the kv heads
    # shared in place) at 32:4, MQA and other ratios
    h1, d1 = 16, 128
    bf, f32 = torch.bfloat16, torch.float32
    cases = [("gpt3-1.3b", TRAIN_B, TRAIN_S, TRAIN_S, h1, d1, True, bf, True,
              None),
             ("tinyllama-1.1b gqa 32:4", TRAIN_LLAMA_B, TRAIN_S, TRAIN_S, 32,
              64, True, bf, False, 4),
             ("gqa 32:4 bf16 d=64 S=2048 causal=False", 1, TRAIN_S, TRAIN_S,
              32, 64, False, bf, False, 4)]
    for causal in (True, False):
        cases += [
            (f"ragged bf16 d=128 causal={causal}", 2, 77, 77, h1, d1,
             causal, bf, True, None),
            (f"bf16 d=64 causal={causal}", 2, 200, 200, 2, 64, causal, bf,
             True, None),
            (f"bf16 d=32 causal={causal}", 2, 130, 130, 4, 32, causal, bf,
             True, None),
            (f"fp32 d=32 causal={causal}", 2, 77, 77, 4, 32, causal, f32,
             True, None),
            (f"fp32 d=64 causal={causal}", 1, 130, 130, 2, 64, causal, f32,
             True, None),
            (f"fp32 d=128 causal={causal}", 1, 77, 77, 2, 128, causal, f32,
             True, None),
            (f"unpacked bf16 sq=77 sk=100 causal={causal}", 2, 77, 100, 4,
             64, causal, bf, False, None),
            (f"gqa 32:1 bf16 d=64 S=200 causal={causal}", 2, 200, 200, 32,
             64, causal, bf, False, 1),
            (f"gqa 8:2 bf16 d=128 S=77 causal={causal}", 2, 77, 77, 8, 128,
             causal, bf, False, 2),
            (f"gqa 8:4 bf16 d=32 S=130 causal={causal}", 2, 130, 130, 8, 32,
             causal, bf, False, 4),
            (f"gqa 8:2 bf16 sq=77 sk=100 causal={causal}", 2, 77, 100, 8,
             64, causal, bf, False, 2),
            (f"gqa 8:2 fp32 d=64 S=130 causal={causal}", 1, 130, 130, 8, 64,
             causal, f32, False, 2),
            (f"gqa 8:1 fp32 d=32 sq=77 sk=100 causal={causal}", 2, 77, 100,
             8, 32, causal, f32, False, 1),
            (f"gqa 4:2 fp32 d=128 S=77 causal={causal}", 1, 77, 77, 4, 128,
             causal, f32, False, 2)]
    for name, b_, sq, sk, h_, d_, causal, dt, packed, kvh in cases:
        e = _check_attention(name, b_, sq, sk, h_, d_, causal, dt, g,
                             packed, kvh)
        sfx = "" if kvh is None else "_gqa"
        rec["flash_fwd" + sfx]["max_abs_err"] = max(
            rec["flash_fwd" + sfx]["max_abs_err"], e["out"], e["lse"])
        rec["flash_bwd" + sfx]["max_abs_err"] = max(
            rec["flash_bwd" + sfx]["max_abs_err"], e["dq"], e["dk"], e["dv"])
    # K4 at one query row, a dense decode step's shape (no backward):
    # Sq = Sk = 1 and Sq = 1 < Sk, MHA at d=128 and 32:4 at d=64
    n_dec, dec_err = 0, 0.0
    for dt in (bf, f32):
        for h_, kvh_, d_ in ((16, 16, 128), (32, 4, 64)):
            for sk in (1, 77, 512, 4096):
                name = (f"decode sq=1 sk={sk} {h_}:{kvh_} d={d_} "
                        f"{str(dt)[6:]}")
                e = _check_attention_fwd(name, TRAIN_B, 1, sk, h_, d_, dt, g,
                                         kvh_)
                key = "flash_fwd" if kvh_ == h_ else "flash_fwd_gqa"
                rec[key]["max_abs_err"] = max(rec[key]["max_abs_err"],
                                              e["out"], e["lse"])
                dec_err = max(dec_err, e["out"], e["lse"])
                n_dec += 1
    print(f"[train_kernels] K4 at one query row: {n_dec} cases (Sk 1, 77, "
          f"512, 4096; 16:16 d=128 and 32:4 d=64; bf16 and fp32, B="
          f"{TRAIN_B}) held per element against the plain version (out "
          f"and lse), two calls the same bytes")
    rec["flash_fwd_decode"] = dict(
        max_abs_err=dec_err, times=[_time_decode(*s, g) for s in
                                    DECODE_SHAPES])
    for t_ in rec["flash_fwd_decode"]["times"]:
        print(f"[train_kernels] K4 decode {t_['shape']}: card ms kernel "
              f"{t_['ms']:.5f}, plain {t_['plain_ms']:.5f}, sdpa "
              f"{t_['library_ms']:.5f}, bound {t_['bound_ms']:.6f} "
              f"({t_['bound_by']})")
    torch.cuda.synchronize()
    rec["no_repeat"] = _no_repeat_memory(g)

    # K6 / K7 (head-major [B*H,S,D]): GPT-3 1.3B's shape, TinyLlama's 32:4
    # as the ramp repeats it to 32 heads, a ragged Sq < Sk, and views at
    # the strides of the fused op's B=1 projection; fp32 and bf16, causal
    # on and off
    for causal in (True, False):
        for dt, tag in ((bf, "bf16"), (f32, "fp32")):
            for key, name, groups, sq, sk, d_ in (
                    ("_hm", "gpt3-1.3b", TRAIN_B * h1, TRAIN_S, TRAIN_S, d1),
                    ("_hm_ramp", "tinyllama ramp", TRAIN_LLAMA_B * 32,
                     TRAIN_S, TRAIN_S, 64),
                    ("_hm", "ragged sq=77 sk=100", 6, 77, 100, 64),
                    ("_hm", "d=32 S=300", 4, 300, 300, 32),
                    ("_hm", "strided S=200", 16, 200, 200, 128)) + (
                    (("_hm", "ragged sq=200 sk=77", 4, 200, 77, 64),)
                    if dt == bf else ()):
                e = _check_attention_hm(
                    f"hm {name} {tag} causal={causal}", groups, sq, sk, d_,
                    causal, dt, g, strided=name.startswith("strided"))
                rec["flash_fwd" + key]["max_abs_err"] = max(
                    rec["flash_fwd" + key]["max_abs_err"], e["out"],
                    e["lse"])
                rec["flash_bwd" + key]["max_abs_err"] = max(
                    rec["flash_bwd" + key]["max_abs_err"], e["dq"],
                    e["dk"], e["dv"])
                torch.cuda.empty_cache()

    # K8 (the head-major two-kernel backward): the long step's shape (G=16
    # at S=16384, where K6 runs too; two heads at a time: the plain
    # version holds S^2 fp32 a head, 1 GiB), GPT-3 1.3B's 2K shape and a
    # ragged Sq < Sk; fp32 and bf16, causal on and off; then K8 against
    # K7 at S=2048 and at K7's longest, 8192
    for causal in (True, False):
        for dt, tag in ((bf, "bf16"), (f32, "fp32")):
            for key, name, groups, sq, sk, d_, chunk in (
                    ("_long", "gpt3-1.3b 16K", h1, LONG_S, LONG_S, d1, 2),
                    ("", "gpt3-1.3b", TRAIN_B * h1, TRAIN_S, TRAIN_S, d1,
                     16),
                    ("", "ragged sq=77 sk=100", 6, 77, 100, 64, 16),
                    ("", "d=32 S=300", 4, 300, 300, 32, 16)) + (
                    (("", "ragged sq=200 sk=77", 4, 200, 77, 64, 16),)
                    if dt == bf else ()):
                e = _check_attention_hm(
                    f"hm K8 {name} {tag} causal={causal}", groups, sq, sk,
                    d_, causal, dt, g, chunk=chunk, split=True)
                fk = rec["flash_fwd_hm" + key]
                fk["max_abs_err"] = max(fk["max_abs_err"], e["out"],
                                        e["lse"])
                bk = rec["flash_bwd_hm_split"]
                bk["max_abs_err"] = max(bk["max_abs_err"], e["dq"],
                                        e["dk"], e["dv"])
                torch.cuda.empty_cache()
    for groups, s_, chunk, variants in (
            (TRAIN_B * h1, TRAIN_S, 16, ((bf, True), (bf, False),
                                         (f32, True), (f32, False))),
            (h1, 8192, 4, ((bf, True), (f32, True)))):
        for dt, causal in variants:
            e = _check_k8_against_k7(groups, s_, d1, causal, dt, g, chunk)
            rec["k8_vs_k7"]["max_abs_err"] = max(
                rec["k8_vs_k7"]["max_abs_err"], *e.values())
            torch.cuda.empty_cache()

    rec["routes"] = _hm_backward_routes(g)
    rec["flash_routes"] = _flash_routes(g)

    # timing at the step's shapes (bf16): card ms per call from CUDA
    # events over calls captured in a CUDA graph
    x = (torch.randn(rows, 2048, generator=g, device="cuda") * 2 + 0.5
         ).to(torch.bfloat16)
    w = torch.randn(2048, generator=g, device="cuda").to(torch.bfloat16)
    bb = torch.randn(2048, generator=g, device="cuda").to(torch.bfloat16)
    gy = torch.randn(rows, 2048, generator=g, device="cuda").to(
        torch.bfloat16)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [2048], w, bb, 1e-5)
    ln_bytes = 3 * rows * 2048 * 2 + 3 * 2048 * 2
    t = dict(shape=f"[{rows}, 2048] bf16")
    t["bound_ms"], t["bound_by"] = _bound_of(
        dict(flops=17 * rows * 2048, bytes=ln_bytes), FP32_FLOPS)
    t["ms"] = device_ms(lambda: norm.layer_norm_bwd_cuda(x, w, gy, 1e-5),
                        iters=20, reps=11)
    t["plain_ms"] = device_ms(lambda: norm._ln_bwd_ref(x, w, gy, 1e-5),
                              iters=5, reps=5)
    t["library_ms"] = device_ms(
        lambda: torch.ops.aten.native_layer_norm_backward(
            gy, x, [2048], mean, rstd, w, bb, [True, True, True]),
        iters=20, reps=11)
    rec["layer_norm_bwd"].update(t)
    del x, gy, mean, rstd

    # K2 at the GPT steps' shape and K1 at TinyLlama's (B=8, S=2048, E
    # 2048): card ms beside the bound and F.layer_norm / F.rms_norm
    lib_rms = getattr(TF, "rms_norm", None)
    for key, r_, fwd, plain, lib, params, flops in (
            ("layer_norm_train", rows,
             lambda x_, w_, b_: norm.layer_norm_cuda(x_, w_, b_, 1e-5),
             lambda x_, w_, b_: norm._ln_ref(x_, w_, b_, 1e-5),
             lambda x_, w_, b_: TF.layer_norm(x_, (2048,), w_, b_, 1e-5),
             2, 8),
            ("rms_norm_train", TRAIN_LLAMA_B * TRAIN_S,
             lambda x_, w_, b_: fused_ops.rms_norm_cuda(x_, w_, 1e-6),
             lambda x_, w_, b_: fused_ops._rms_norm_ref(x_, w_, 1e-6),
             None if lib_rms is None else (
                 lambda x_, w_, b_: lib_rms(x_, (2048,), w_, 1e-6)),
             1, 4)):
        x = (torch.randn(r_, 2048, generator=g, device="cuda") * 2 + 0.5
             ).to(torch.bfloat16)
        err, ok, worst = max_err_within_tol(fwd(x, w, bb), plain(x, w, bb))
        check(ok, f"{key} [{r_}, 2048] bf16: max err {err}, worst element "
                  f"{worst}")
        t = dict(shape=f"[{r_}, 2048] bf16", max_abs_err=err)
        t["bound_ms"], t["bound_by"] = _bound(r_, 2048, 2, params, flops)
        for name, fn in (("ms", fwd), ("plain_ms", plain),
                         ("library_ms", lib)):
            t[name] = None if fn is None else device_ms(
                partial(fn, x, w, bb), iters=20, reps=11)
        rec[key] = t
        del x

    for suffix, b_, h_, kvh, d_ in (("", TRAIN_B, h1, h1, d1),
                                    ("_gqa", TRAIN_LLAMA_B, 32, 4, 64)):
        rec["flash_fwd" + suffix].update(
            _time_attention("fwd", b_, h_, kvh, d_, g))
        rec["flash_bwd" + suffix].update(
            _time_attention("bwd", b_, h_, kvh, d_, g))
    for suffix, b_, h_, d_ in (("_hm", TRAIN_B, h1, d1),
                               ("_hm_ramp", TRAIN_LLAMA_B, 32, 64)):
        for which in ("fwd", "bwd"):
            rec[f"flash_{which}{suffix}"].update(
                _time_attention_hm(which, b_, h_, d_, g))
    # K6 and K8 at the long step's shape (B=1, S=16384), and K8 at the 2K
    # GPT shape beside K7's
    rec["flash_fwd_hm_long"].update(
        _time_attention_hm("fwd", 1, h1, d1, g, s=LONG_S))
    rec["flash_bwd_hm_split"].update(
        _time_attention_hm("bwd", 1, h1, d1, g, s=LONG_S))
    torch.cuda.empty_cache()
    rec["flash_bwd_hm_split"]["at_2k"] = _time_attention_hm(
        "bwd", TRAIN_B, h1, d1, g, split=True)
    torch.cuda.empty_cache()
    k8_2k = rec["flash_bwd_hm_split"]["at_2k"]
    print(f"[train_kernels] flash_bwd_hm_split {k8_2k['shape']}: card ms: "
          f"kernel {k8_2k['ms']:.5f} (K7 {rec['flash_bwd_hm']['ms']:.5f}), "
          f"plain {k8_2k['plain_ms']:.5f}, library "
          f"{k8_2k['library_ms']:.5f}, bound {k8_2k['bound_ms']:.6f}")
    for key in ("layer_norm_train", "rms_norm_train"):
        r = rec[key]
        print(f"[train_kernels] {key} {r['shape']}: card ms: kernel "
              f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library "
              f"{r['library_ms']}, bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}); kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of its bound")
    for key in ("layer_norm_bwd", "flash_fwd", "flash_bwd", "flash_fwd_gqa",
                "flash_bwd_gqa", "flash_fwd_hm", "flash_bwd_hm",
                "flash_fwd_hm_ramp", "flash_bwd_hm_ramp",
                "flash_fwd_hm_long", "flash_bwd_hm_split"):
        r = rec[key]
        by_op = ", ".join(f"{n} {v:.5f}" for n, v in r.get(
            "library_ms_by_op", {}).items()) or "native_layer_norm_backward"
        print(f"[train_kernels] {key} {r['shape']}: card ms: kernel "
              f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, library "
              f"{r['library_ms']:.5f} ({by_op}), bound {r['bound_ms']:.6f} "
              f"({r['bound_by']}); kernel at "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of its bound")
    return rec


def _fp32_entries(fa):
    """The attention kernels' fp32 entry points, which no bf16 training
    step may reach: K4, K5 and K6 in fp32."""
    return (fa.FLASH_FWD_FP32_KERNEL, fa.FLASH_BWD_FP32_KERNEL,
            fa.FLASH_FWD_HM_FP32_KERNEL)


def _train_counts(kernels):
    return {k.symbol: (k.launches, k.plain_calls) for k in kernels}


def _train(tag, title, model, batch, path, per_step, absent, warmup=2,
           timed=3, profile=True, seq=TRAIN_S, recipe=None, inspect=None):
    """``warmup`` and ``timed`` bf16 O2 AdamW steps of ``model`` on one
    batch of [batch, seq] tokens from a seed, through the port's entry
    points: AdamW with fp32 masters and moments, or ``recipe(model)`` ->
    (model, optimizer, LR scheduler or None; stepped after each step).
    Every kernel of ``path`` must launch ``per_step`` times a step with 0
    plain calls, every kernel of ``absent`` never; the loss must be
    finite and, over two or more timed steps, fall.
    ``inspect(model, opt)`` runs after the timed steps; its dict joins
    the result."""
    import paddle_tpu_torch as ptt

    cfg = model.cfg
    sched = None
    if recipe is None:
        opt = ptt.optimizer.AdamW(parameters=model.parameters(),
                                  learning_rate=1e-4, use_multi_tensor=True,
                                  multi_precision=True)
        model, opt = ptt.amp.decorate(models=model, optimizers=opt,
                                      level="O2", dtype="bfloat16")
    else:
        model, opt, sched = recipe(model)
    n_params = sum(p.numel() for p in model.parameters())
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, cfg.vocab_size,
                                     (batch, seq + 1)), device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]

    def step():
        with ptt.amp.auto_cast(level="O2", dtype="bfloat16"):
            _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            sched.step()
        return loss.detach()

    everything = path + absent
    for k in everything:
        k.reset_counts()
    losses = [step() for _ in range(warmup)]
    torch.cuda.synchronize()
    timed_losses, t_steps = sync_time(lambda: [step() for _ in range(timed)])
    counts = _train_counts(everything)
    losses = [float(v) for v in losses + timed_losses]
    n_steps = len(losses)
    check(all(np.isfinite(losses)), f"{tag}: loss not finite: {losses}")
    check(timed < 2 or losses[-1] < losses[warmup],
          f"{tag}: loss did not fall over the timed steps: {losses}")
    for k, want in zip(path, per_step):
        got, plain = counts[k.symbol]
        check(got == want * n_steps and plain == 0,
              f"{tag}: {k.symbol} launched {got} times, plain {plain} "
              f"times in {n_steps} steps (want {want} per step, 0 plain)")
    for k in absent:
        check(counts[k.symbol] == (0, 0), f"{tag}: {k.symbol} ran")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = t_steps / timed * 1e3
    tokens = batch * seq
    d = cfg.hidden_size // cfg.num_heads
    pairs, fwd_work, _ = _attn_work(batch, seq, seq, cfg.num_heads, d, True)
    attn_flops = 3 * cfg.num_layers * fwd_work["flops"]
    model_flops = 6 * n_params * tokens + attn_flops
    res = dict(batch=batch, seq=seq, steps=n_steps, losses=losses,
               step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               peak_gb=peak_gb, params=n_params, model_flops=model_flops,
               mfu=model_flops / (step_ms / 1e3) / BF16_FLOPS,
               launches={s_: c[0] for s_, c in counts.items()},
               plain_calls={s_: c[1] for s_, c in counts.items()})
    if inspect is not None:
        res.update(inspect(model, opt))
    print(f"[{tag}] {title} ({n_params / 1e9:.3f} B params), B={batch}, "
          f"S={seq}, bf16 O2 AdamW: losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; step {step_ms:.1f} ms, {res['tokens_per_s']:.0f} tokens/s, "
          f"MFU {100 * res['mfu']:.1f}% (6N + attention FLOPs over 989 "
          f"TFLOP/s), peak {peak_gb:.1f} GiB")
    print(f"[{tag}] launches in {n_steps} steps: "
          + ", ".join(f"{s_} {c[0]}" for s_, c in counts.items())
          + "; plain calls 0")
    card_ms, top = device_breakdown(step, top=10) if profile else (None, [])
    if card_ms is not None:
        res.update(step_device_ms=card_ms, device_busy=card_ms / step_ms,
                   top_kernels=top)
        print(f"[{tag}] card time of one step {card_ms:.1f} ms = "
              f"{100 * card_ms / step_ms:.0f}% of the host-clock step")
        for t_ in top:
            print(f"[{tag}]   {t_['ms']:9.2f} ms {t_['calls']:6d}x "
                  f"{t_['kernel']}")
    elif profile:
        print(f"[{tag}] card time: not measured (the profiler recorded no "
              f"device events)")
    del model, opt, x, y, ids
    torch.cuda.empty_cache()
    return res


def phase_train():
    """GPT-3 1.3B, B=4, S=2048: K4/K5 and K2/K3 on every attention and
    LayerNorm (24/24/49/49 launches a step)."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.functional import norm

    cfg = gpt3_1p3b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30  # held by earlier phases
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))
    n = cfg.num_layers
    res = _train("train", "GPT-3 1.3B", model, TRAIN_B,
                 (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL,
                  norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL),
                 (n, n, 2 * n + 1, 2 * n + 1),
                 (fused_ops.RMS_NORM_KERNEL,) + _fp32_entries(fa))
    res["base_gb"] = base_gb
    print(f"[train] {base_gb:.1f} GiB of the peak was held before the phase")
    return res


def _with_flag(name, value, fn):
    """fn() with the port's FLAGS_<name> = value, restored in finally."""
    from paddle_tpu_torch.core import flags

    old = flags.get_flag(name)
    flags.set_flags({name: value})
    try:
        return fn()
    finally:
        flags.set_flags({name: old})


def phase_train_fused():
    """GPT-3 1.3B, B=4, S=2048 with FLAGS_use_fused_attention: every
    attention block is one fused_self_attention op on K6/K7, every
    LayerNorm K2/K3 (24/24/49/49 launches a step); K4/K5 never run."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.functional import norm

    cfg = gpt3_1p3b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))
    n = cfg.num_layers
    res = _with_flag("use_fused_attention", True, lambda: _train(
        "train_fused", "GPT-3 1.3B, FLAGS_use_fused_attention", model,
        TRAIN_B,
        (fa.FLASH_FWD_HM_KERNEL, fa.FLASH_BWD_HM_KERNEL,
         norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL),
        (n, n, 2 * n + 1, 2 * n + 1),
        (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL,
         fa.FLASH_BWD_HM_FP32_KERNEL, fa.FLASH_BWD_HM_SPLIT_KERNEL,
         fused_ops.RMS_NORM_KERNEL) + _fp32_entries(fa)))
    res["base_gb"] = base_gb
    print(f"[train_fused] {base_gb:.1f} GiB of the peak was held before the "
          f"phase")
    return res


def phase_train_long():
    """GPT-3 1.3B at 16K context (max_seq_len 16384, B=1, S=16384) with
    FLAGS_use_fused_attention: Sq*D*4 = 8 MiB passes the one-pass
    backward's budget, so every attention backward is K8 (24 K6, 24 K8,
    49 K2, 49 K3 launches a step; K4/K5/K7 never)."""
    from dataclasses import replace

    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.functional import norm

    cfg = replace(gpt3_1p3b(), max_seq_len=LONG_S)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))
    n = cfg.num_layers
    # the strides at which the fused op hands q, k, v to the head-major
    # Function (at B=1 views of its projection: group stride D, row 3E)
    strides = set()
    real = fa._flash_hm

    def spy(qh, kh, vh, causal):
        strides.add((qh.stride(), kh.stride(), vh.stride()))
        return real(qh, kh, vh, causal)
    fa._flash_hm = spy
    try:
        res = _with_flag("use_fused_attention", True, lambda: _train(
            "train_long", "GPT-3 1.3B at 16K, FLAGS_use_fused_attention",
            model, 1,
            (fa.FLASH_FWD_HM_KERNEL, fa.FLASH_BWD_HM_SPLIT_KERNEL,
             norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL),
            (n, n, 2 * n + 1, 2 * n + 1),
            (fa.FLASH_BWD_HM_KERNEL, fa.FLASH_FWD_KERNEL,
             fa.FLASH_BWD_KERNEL, fa.FLASH_BWD_HM_SPLIT_FP32_KERNEL,
             fused_ops.RMS_NORM_KERNEL) + _fp32_entries(fa), seq=LONG_S))
    finally:
        fa._flash_hm = real
    d, e = cfg.hidden_size // cfg.num_heads, cfg.hidden_size
    res["qkv_strides"] = sorted(strides)
    res["qkv_in_place"] = strides == {((d, 3 * e, 1),) * 3}
    res["base_gb"] = base_gb
    print(f"[train_long] q, k, v reach the kernels at strides "
          f"{sorted(strides)}: "
          + ("views of the projection, read in place" if res["qkv_in_place"]
             else "not the projection's views"))
    print(f"[train_long] {base_gb:.1f} GiB of the peak was held before the "
          f"phase")
    return res


def phase_train_hm():
    """FLAGS_flash_native_layout=0 at full width, 2 layers, 2 steps each:
    GPT-3 1.3B's width (B=4) through the unpack route and TinyLlama's
    (B=8, GQA 32:4) through the ramp; K6/K7 launch once a layer each way,
    K4/K5 never."""
    from dataclasses import replace

    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_1p3b)
    from paddle_tpu_torch.nn.functional import norm

    native = (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL)
    hm = (fa.FLASH_FWD_HM_KERNEL, fa.FLASH_BWD_HM_KERNEL)
    out = {}
    for key, title, build, batch, norms, absent in (
            ("gpt", "GPT-3 1.3B width, 2 layers, unpack route",
             lambda: GPTForCausalLM(replace(gpt3_1p3b(), num_layers=2),
                                    device="cuda",
                                    generator=seed(1234, "cuda")),
             TRAIN_B, (norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL),
             native + (fused_ops.RMS_NORM_KERNEL,)),
            ("tinyllama", "TinyLlama-1.1B width, 2 layers, GQA ramp",
             lambda: LlamaForCausalLM(
                 replace(tinyllama_1p1b(), num_layers=2), device="cuda",
                 generator=seed(1234, "cuda")),
             TRAIN_LLAMA_B, (fused_ops.RMS_NORM_KERNEL,),
             native + (norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = build()
        n = model.cfg.num_layers
        out[key] = _with_flag("flash_native_layout", False, lambda: _train(
            f"train_hm {key}", title, model, batch, hm + norms,
            (n, n) + (2 * n + 1,) * len(norms), absent, warmup=1, timed=1,
            profile=False))
        del model
    return out


def tinyllama_1p1b():
    """TinyLlama-1.1B's geometry (bench.py `bench_llama`): 22 layers of
    E 2048, 32 heads of d=64 over 4 kv heads (GQA 8:1), SwiGLU 5632."""
    from paddle_tpu_torch.models import LlamaConfig

    return LlamaConfig(vocab_size=32000, hidden_size=2048, num_layers=22,
                       num_heads=32, num_kv_heads=4, intermediate_size=5632,
                       max_seq_len=2048, rope_theta=10000.0, rms_eps=1e-6)


def phase_train_llama():
    """TinyLlama-1.1B, B=8, S=2048: K4/K5 over the shared kv heads on
    every attention and K1 on every RMSNorm (22/22/45 launches a step);
    the LayerNorm kernels never run."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.nn.functional import norm

    cfg = tinyllama_1p1b()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 2 ** 30
    model = LlamaForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))
    n = cfg.num_layers
    res = _train("train_llama", "TinyLlama-1.1B (GQA 32:4)", model,
                 TRAIN_LLAMA_B,
                 (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL,
                  fused_ops.RMS_NORM_KERNEL),
                 (n, n, 2 * n + 1),
                 (norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL)
                 + _fp32_entries(fa))
    res["base_gb"] = base_gb
    print(f"[train_llama] {base_gb:.1f} GiB of the peak was held before the "
          f"phase")
    return res


def _recipe(gpt):
    """bench.py's single-chip optimizer plan (`bench_gpt13b`, `bench_llama`):
    AdamW with bf16 moments, stochastic rounding and use_multi_tensor, the
    model decorated O2 without master weights. GPT adds GPT-3's
    pretraining options (Brown et al. 2020, appendix B), JAX package
    features both: a linear warm-up into a cosine decay and a global-norm
    clip at 1.0. -> recipe(model) -> (model, optimizer, scheduler)."""
    import paddle_tpu_torch as ptt

    def build(model):
        lr, extra, sched = 1e-4, {}, None
        if gpt:
            sched = lr = ptt.optimizer.lr.LinearWarmup(
                ptt.optimizer.lr.CosineAnnealingDecay(1e-4, T_max=3),
                warmup_steps=2, start_lr=0.0, end_lr=1e-4)
            extra["grad_clip"] = ptt.nn.ClipGradByGlobalNorm(1.0)
        opt = ptt.optimizer.AdamW(parameters=model.parameters(),
                                  learning_rate=lr, use_multi_tensor=True,
                                  moment_dtype="bfloat16",
                                  stochastic_rounding=True, **extra)
        model, opt = ptt.amp.decorate(models=model, optimizers=opt,
                                      level="O2", dtype="bfloat16",
                                      master_weight=False)
        return model, opt, sched
    return build


def _recipe_state(tag):
    """inspect(model, opt) of a recipe run: the persistent bytes of the
    parameters, their gradients (bf16, live from the backward to
    clear_grad) and the optimizer state, its dtype census, and the checks
    of the plan: every parameter bf16, no fp32 master, bf16 moments above
    2^18 elements and fp32 ones (the multi-tensor path's) below."""
    def inspect(model, opt):
        big = opt._FUSE_MAX_NUMEL
        params = list(model.parameters())
        p_bytes = sum(p.numel() * p.element_size() for p in params)
        check(all(p.dtype == torch.bfloat16 for p in params),
              f"{tag}: a parameter is not bf16")
        check(not opt._master_weights, f"{tag}: fp32 master weights exist")
        census, s_bytes = {}, 0
        for acc, store in opt._accumulators.items():
            for name, t in store.items():
                if not isinstance(t, torch.Tensor):
                    continue            # the beta powers: host scalars
                key = f"{acc} {str(t.dtype)[6:]}"
                n, c = census.get(key, (0, 0))
                census[key] = (n + 1, c + t.numel())
                s_bytes += t.numel() * t.element_size()
        for p in params:
            name = opt._name(p)
            for acc in ("moment1", "moment2"):
                t = opt._accumulators[acc][name]
                want = torch.bfloat16 if p.numel() > big else torch.float32
                check(t.dtype == want, f"{tag}: {name} {acc} is {t.dtype}, "
                      f"want {want} ({p.numel()} elements)")
        print(f"[{tag}] persistent: parameters {p_bytes / 1e9:.3f} GB "
              f"(bf16), gradients {p_bytes / 1e9:.3f} GB (bf16), optimizer "
              f"state {s_bytes / 1e9:.3f} GB; census (tensors, elements): "
              + ", ".join(f"{k} {v[0]} / {v[1]}" for k, v in
                          sorted(census.items()))
              + f"; beta powers host fp32; fp32 masters: none")
        return dict(param_bytes=p_bytes, grad_bytes=p_bytes,
                    state_bytes=s_bytes,
                    census={k: list(v) for k, v in census.items()})
    return inspect


def phase_train_recipe():
    """The JAX package's single-chip training recipes at full width and
    depth: GPT-3 1.3B (bench.py:276-311, `bench_gpt13b`) and
    TinyLlama-1.1B (bench.py:376-407, `bench_llama`), B=8, S=2048,
    recompute, bf16 moments with stochastic rounding, no fp32 masters
    (GPT with the warm-up-cosine schedule and the global-norm clip).
    Each recomputed block runs its norms and attention forward twice:
    GPT 97 K2 (49 + 48), 49 K3, 48 K4 (24 + 24), 24 K5 a step; TinyLlama
    89 K1 (45 + 44), 44 grouped K4, 22 grouped K5."""
    from dataclasses import replace

    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_1p3b)
    from paddle_tpu_torch.nn.functional import norm

    out = {}
    ln = (norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL)
    attn = (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL)
    hm = (fa.FLASH_FWD_HM_KERNEL, fa.FLASH_BWD_HM_KERNEL,
          fa.FLASH_BWD_HM_SPLIT_KERNEL)
    for key, title, build, path, per_step, absent in (
            ("gpt", "GPT-3 1.3B, recompute, bf16 moments + SR, no masters",
             lambda: GPTForCausalLM(gpt3_1p3b(recompute=True), device="cuda",
                                    generator=seed(1234, "cuda")),
             attn + ln, lambda n: (2 * n, n, 4 * n + 1, 2 * n + 1),
             (fused_ops.RMS_NORM_KERNEL,) + hm + _fp32_entries(fa)),
            ("tinyllama", "TinyLlama-1.1B (GQA 32:4), recompute, bf16 "
             "moments + SR, no masters",
             lambda: LlamaForCausalLM(replace(tinyllama_1p1b(),
                                              recompute=True), device="cuda",
                                      generator=seed(1234, "cuda")),
             attn + (fused_ops.RMS_NORM_KERNEL,),
             lambda n: (2 * n, n, 4 * n + 1),
             ln + hm + _fp32_entries(fa))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 2 ** 30
        model = build()
        n = model.cfg.num_layers
        tag = f"train_recipe {key}"
        res = _train(tag, title, model, TRAIN_LLAMA_B, path, per_step(n),
                     absent, recipe=_recipe(key == "gpt"),
                     inspect=_recipe_state(tag))
        if key == "gpt":
            # lr 0 at the first step: the weights must not move (stochastic
            # rounding leaves representable values as they are)
            check(res["losses"][0] == res["losses"][1],
                  f"{tag}: the weights moved at lr 0: {res['losses']}")
        res["base_gb"] = base_gb
        print(f"[{tag}] MFU counts 6 N B S plus attention; the recomputed "
              f"forward is not counted. {base_gb:.1f} GiB of the peak was "
              f"held before the phase")
        out[key] = res
        del model
    return out


def phase_train_card_vs_cpu():
    """One fp32 training step of gpt_tiny, of gpt_tiny with
    FLAGS_use_fused_attention (K6/K7 on the card) and of llama_tiny at GQA
    4:2 on the card and on the CPU from the same weights: the loss, every
    gradient and the updated weights. Tolerances: loss 1e-5 relative and
    gradients 1e-4 of each tensor's largest value (cuBLAS and the kernels'
    tiles sum in other orders than the CPU); weights after AdamW every
    element within 1e-4, a tenth of the lr, and 99.9% within 1e-6 (Adam
    divides a near-zero gradient by its own tiny RMS, so such an element's
    step follows that gradient's last bits)."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)

    out = {}
    for family, cls, cfg, fused in (
            ("gpt_tiny", GPTForCausalLM, gpt_tiny(), False),
            ("gpt_tiny fused attention", GPTForCausalLM, gpt_tiny(), True),
            ("llama_tiny gqa 4:2", LlamaForCausalLM,
             llama_tiny(num_kv_heads=2), False)):
        rs = np.random.RandomState(11)
        ids = rs.randint(0, cfg.vocab_size, (2, cfg.max_seq_len + 1))
        cpu = cls(cfg, device="cpu", generator=seed(7, "cpu"))
        gpu = cls(cfg, device="cuda")
        gpu.load_state_dict(cpu.state_dict())

        def one_step(m):
            dev = next(m.parameters()).device
            x = torch.as_tensor(ids[:, :-1], device=dev)
            y = torch.as_tensor(ids[:, 1:], device=dev)
            opt = ptt.optimizer.AdamW(parameters=m.parameters(),
                                      learning_rate=1e-3,
                                      use_multi_tensor=True,
                                      multi_precision=True)
            _, loss = m(x, labels=y)
            loss.backward()
            grads = {n: p.grad.detach().cpu().clone()
                     for n, p in m.named_parameters()}
            opt.step()
            return (loss.item(), grads,
                    {n: p.detach().cpu() for n, p in m.named_parameters()})
        res = {tag: _with_flag("use_fused_attention", fused,
                               partial(one_step, m))
               for tag, m in (("cpu", cpu), ("card", gpu))}
        (lc, gc, wc), (lg, gg, wg) = res["cpu"], res["card"]
        check(abs(lc - lg) <= 1e-5 * abs(lc),
              f"train card-vs-cpu {family}: loss {lg} vs {lc}")
        werr = []
        for n in gc:
            top = float(gc[n].abs().max())
            gd = float((gg[n] - gc[n]).abs().max())
            check(gd <= 1e-4 * top, f"train card-vs-cpu {family}: grad {n}: "
                                    f"max err {gd} > {1e-4 * top}")
            wd = (wg[n] - wc[n]).abs()
            check(float(wd.max()) <= 1e-4,
                  f"train card-vs-cpu {family}: weight {n}: max err "
                  f"{float(wd.max())}")
            werr.append(wd.reshape(-1))
        frac = float((torch.cat(werr) <= 1e-6).float().mean())
        check(frac >= 0.999, f"train card-vs-cpu {family}: only {frac:.5f} "
                             f"of weights within 1e-6")
        print(f"[train-card-vs-cpu] {family} fp32 step: loss {lg:.6f} (cpu "
              f"{lc:.6f}); all {len(gc)} gradients within 1e-4 of their "
              f"max; updated weights within 1e-4, {100 * frac:.3f}% within "
              f"1e-6")
        out[family] = dict(loss_card=lg, loss_cpu=lc,
                           weights_within_1e6=frac)
    return out


# K9's shape on the main path: the hidden state of a GPT-3 1.3B training
# step (B=4, S=2048, E=2048); the factors of the reference test (2.0) and
# two that round in bf16
SCALE_SHAPE = (TRAIN_B, TRAIN_S, 2048)
SCALE_FACTORS = (2.0, 0.1, 1 / 3)
FFN_ROWS, FFN_STEPS = 8192, 10  # [custom_op] (d): rows of data, SGD steps
# K9's shape, dtype and factor in the FFN of (d): its hidden activation
# [rows, 4 * 2048] and that activation's gradient, bf16 under O2, x0.5
FFN_SCALE = ((FFN_ROWS, 4 * 2048), torch.bfloat16, 0.5)
CPP_SOURCE = r"""
#include <cstdint>
#include <cmath>
extern "C" void softclip(const float* in, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = std::tanh(in[i]);
}
extern "C" void plus_one(const float* in, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] + 1.0f;
}
"""


def scale_cases(g):
    """[(name, x, factor)] of [custom_op] (a), fp32 and bf16: the
    register_op path's shape at every factor; the reference test's
    [2, 4], n = 1 and n = 4097 (a vector tail), a view whose base is
    offset by one element (a scalar head) and a transposed view, each at
    every factor; an empty tensor; and the FFN path's shape, dtype and
    factor (FFN_SCALE)."""
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag = str(dt).split(".")[-1]

        def rand(*shape):
            return torch.randn(*shape, generator=g, device="cuda").to(dt)

        for f in SCALE_FACTORS:
            cases += [
                (f"{list(SCALE_SHAPE)} {tag} x{f:.4g}", rand(*SCALE_SHAPE), f),
                (f"[2, 4] {tag} x{f:.4g}", rand(2, 4), f),
                (f"n=1 {tag} x{f:.4g}", rand(1), f),
                (f"n=4097 {tag} x{f:.4g}", rand(4097), f),
                (f"offset view n=4097 {tag} x{f:.4g}", rand(4098)[1:], f),
                (f"transposed [130, 96] {tag} x{f:.4g}", rand(96, 130).t(),
                 f)]
        cases.append((f"empty [0, 3] {tag}", rand(0, 3), 2.0))
    shape, dt, f = FFN_SCALE
    cases.append((f"{list(shape)} bfloat16 x{f:.4g}",
                  torch.randn(*shape, generator=g, device="cuda").to(dt), f))
    return cases


def _bits(t):
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def scale_mismatches(x, factor):
    """(elements where K9 and its plain version differ in any bit, max
    |K9 - plain|) on x. K9 writes into an output filled with NaN first,
    so an element it leaves unwritten differs. Fails if K9's result is
    not a contiguous tensor of x's shape and dtype."""
    from paddle_tpu_torch.testing import custom_scale as cs

    alloc = cs._empty_at_offset_of
    cs._empty_at_offset_of = lambda t: alloc(t).fill_(float("nan"))
    try:
        got = cs.scale_cuda(x, factor)
    finally:
        cs._empty_at_offset_of = alloc
    ref = cs.scale_plain(x, factor)
    check(got.shape == x.shape and got.dtype == x.dtype
          and got.is_contiguous(),
          f"scale: got {tuple(got.shape)} {got.dtype} for "
          f"{tuple(x.shape)} {x.dtype}")
    if not x.numel():
        return 0, 0.0
    return (int((_bits(got) != _bits(ref)).sum()),
            float((got.float() - ref.float()).abs().max()))


def _gelu_like(x):
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * (x + 0.044715 * x ** 3)))


def phase_custom_op():
    """The custom-op API on the card: K9 against its plain version bit for
    bit and its times; an op registered with K9 and its VJP, forward and
    backward; an FFN at GPT-3 1.3B's width trained through a registered
    op and the K9 op with SGD under amp O2; cpp_extension.load's host ops
    on CUDA tensors."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.testing import custom_scale as cs
    from paddle_tpu_torch.utils import cpp_extension

    kernel = cs.SCALE_KERNEL
    g = torch.Generator(device="cuda").manual_seed(5)
    rec = {"max_abs_err": 0.0, "cases": 0}
    # (a) K9 against its plain version, bit for bit
    for name, x, f in scale_cases(g):
        before = kernel.launches
        bad, err = scale_mismatches(x, f)
        check(bad == 0, f"scale {name}: {bad} of {x.numel()} elements "
                        f"differ from the plain version (max err {err})")
        check((kernel.launches - before) == (1 if x.numel() else 0),
              f"scale {name}: {kernel.launches - before} launches")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["cases"] += 1
    x = torch.randn(*SCALE_SHAPE, generator=g, device="cuda").bfloat16()
    check(torch.equal(_bits(cs.scale_cuda(x, 0.1)),
                      _bits(cs.scale_cuda(x, 0.1))),
          "scale: two calls gave different bytes")
    torch.cuda.synchronize()
    print(f"[custom_op] K9 equals its plain version bit for bit in "
          f"{rec['cases']} cases (fp32 and bf16, factors 2, 0.1, 1/3; "
          f"{list(SCALE_SHAPE)}, [2, 4], n=1, n=4097, an offset view, a "
          f"transposed view, empty; {list(FFN_SCALE[0])} bf16 x0.5); two "
          f"calls give the same bytes")

    # (b) times at the register_op path's shape, factor 2.0, and at the
    # FFN path's, factor 0.5. torch.mul computes the same function at
    # both factors (each is a bf16 value); it is also the plain version's
    # one call.
    rec["shapes"] = []
    for shape, dt, f in ((SCALE_SHAPE, torch.bfloat16, 2.0),
                         (SCALE_SHAPE, torch.float32, 2.0), FFN_SCALE):
        x = torch.randn(*shape, generator=g, device="cuda").to(dt)
        nbytes = 2 * x.numel() * x.element_size()
        t = dict(shape=f"{list(shape)} {str(dt).split('.')[-1]} x{f:.4g}",
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        for key, fn in (("ms", lambda: cs.scale_cuda(x, f)),
                        ("plain_ms", lambda: cs.scale_plain(x, f)),
                        ("library_ms", lambda: torch.mul(x, f))):
            t[key] = device_ms(fn)
            t["eager_" + key] = eager_ms(fn)
        rec["shapes"].append(t)
        print(f"[custom_op] K9 {t['shape']}: card ms: kernel {t['ms']:.5f}, "
              f"plain {t['plain_ms']:.5f}, torch.mul {t['library_ms']:.5f}, "
              f"bound {t['bound_ms']:.6f} (bytes); kernel at "
              f"{100 * t['bound_ms'] / t['ms']:.1f}% of its bound; eager ms "
              f"per call: kernel {t['eager_ms']:.5f}, plain "
              f"{t['eager_plain_ms']:.5f}, torch.mul "
              f"{t['eager_library_ms']:.5f}")
        del x

    # (c) the register_op path: K9 forward, K9 backward through scale_vjp,
    # on a tensor that to_tensor puts on the card by default
    op = ptt.ops.register_op("custom_scale", cs.scale, vjp=cs.scale_vjp)
    gelu = ptt.ops.register_op("gelu_like", _gelu_like)
    try:
        x = ptt.to_tensor(
            torch.randn(*SCALE_SHAPE, generator=g, device="cuda"),
            dtype="bfloat16", stop_gradient=False)
        check(x.is_cuda and x.requires_grad and x.is_leaf,
              f"to_tensor: got {x.device}, requires_grad "
              f"{x.requires_grad}, leaf {x.is_leaf}")
        kernel.reset_counts()
        out = op(x)
        out.sum().backward()
        torch.cuda.synchronize()
        counts = (kernel.launches, kernel.plain_calls)
        check(counts == (2, 0), f"custom_op: register_op forward and "
                                f"backward ran K9 {counts[0]} times, plain "
                                f"{counts[1]} times (want 2, 0)")
        check(torch.equal(_bits(out), _bits(x.detach() * 2)),
              "custom_op: op(x) != 2x")
        check(bool((x.grad == 2).all()), "custom_op: x.grad is not all 2")
        rec["launches"] = {"register_op": counts[0]}
        print(f"[custom_op] register_op('custom_scale', scale, "
              f"vjp=scale_vjp) on to_tensor's {list(SCALE_SHAPE)} bf16 "
              f"(on {x.device} by default): out == 2x, x.grad all 2.0; K9 "
              f"1 launch forward + 1 backward, 0 plain")
        del x, out

        # PyLayer forward and backward on the card
        class Cube(ptt.PyLayer):
            @staticmethod
            def forward(ctx, v):
                ctx.save_for_backward(v)
                return v * v * v

            @staticmethod
            def backward(ctx, dy):
                (v,) = ctx.saved_tensor()
                return dy * 3 * v * v

        v = ptt.to_tensor(torch.randn(1 << 20, generator=g, device="cuda"),
                          stop_gradient=False)
        out = Cube.apply(v)
        out.backward(torch.ones_like(out))
        vd = v.detach()
        check(out.is_cuda and type(out.grad_fn).__name__ == "CubeBackward"
              and torch.equal(out, vd * vd * vd)
              and torch.equal(v.grad, 3 * vd * vd),
              "PyLayer: Cube's output or x.grad on the card differs from "
              "x^3 and 3x^2")
        print(f"[custom_op] PyLayer Cube on {v.numel()} floats on "
              f"{v.device}: out == x^3, x.grad == 3x^2")
        del v, vd, out

        # (d) an FFN at GPT-3 1.3B's width through the registered ops
        gen = ptt.seed(1234, "cuda")
        lin1 = ptt.nn.Linear(2048, 8192, device="cuda", generator=gen)
        lin2 = ptt.nn.Linear(8192, 2048, device="cuda", generator=gen)
        model = torch.nn.Sequential(lin1, lin2)
        opt = ptt.optimizer.SGD(learning_rate=1.0,
                                parameters=model.parameters())
        model, opt = ptt.amp.decorate(models=model, optimizers=opt,
                                      level="O2")
        x = torch.randn(FFN_ROWS, 2048, generator=g, device="cuda")
        y = torch.randn(FFN_ROWS, 2048, generator=g, device="cuda")
        # the first step keeps each K9 call's input and output, to hold
        # them against the plain version after the counts are read
        seen, launch = [], cs.scale_cuda

        def keep(t, factor=2.0):
            out = launch(t, factor)
            seen.append((t.detach().clone(), factor, out.detach().clone()))
            return out

        def step():
            with ptt.amp.auto_cast(level="O2"):
                h = op(gelu(lin1(x)), factor=0.5)
                loss = ((lin2(h).float() - y) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        kernel.reset_counts()
        cs.scale_cuda = keep
        try:
            warm = [step()]
        finally:
            cs.scale_cuda = launch
        warm.append(step())
        timed, secs = sync_time(
            lambda: [step() for _ in range(FFN_STEPS - 2)])
        launches, plain = kernel.launches, kernel.plain_calls
        losses = [float(v) for v in warm + timed]
        check(all(np.isfinite(losses)), f"custom_op: loss not finite: "
                                         f"{losses}")
        check(losses[-1] < losses[0], f"custom_op: loss did not fall: "
                                       f"{losses}")
        check((launches, plain) == (2 * FFN_STEPS, 0),
              f"custom_op: K9 ran {launches} times, plain {plain} times "
              f"in {FFN_STEPS} FFN steps (want {2 * FFN_STEPS}, 0)")
        shape, dt, f = FFN_SCALE
        check([(tuple(t.shape), t.dtype, fa) for t, fa, _ in seen]
              == [(shape, dt, f)] * 2,
              f"custom_op: the FFN step's K9 calls were "
              f"{[(tuple(t.shape), t.dtype, fa) for t, fa, _ in seen]}, "
              f"want forward and backward at {(shape, dt, f)}")
        ffn_err = 0.0
        for (t, fa, got), part in zip(seen, ("forward", "backward")):
            ref = cs.scale_plain(t, fa)
            bad = int((_bits(got) != _bits(ref)).sum())
            check(bad == 0, f"custom_op: the FFN step's {part} K9 call: "
                            f"{bad} elements differ from the plain version")
            ffn_err = max(ffn_err, float((got.float() - ref.float())
                                         .abs().max()))
        del seen
        step_ms = secs / (FFN_STEPS - 2) * 1e3
        rec["launches"]["ffn train"] = launches
        rec.update(ffn=dict(max_abs_err=ffn_err), ffn_losses=losses,
                   ffn_step_ms=step_ms)
        print(f"[custom_op] FFN Linear(2048, 8192) -> gelu_like op -> K9 op "
              f"x0.5 -> Linear(8192, 2048), {FFN_ROWS} rows, SGD lr 1.0, "
              f"bf16 O2: losses " + ", ".join(f"{v:.6f}" for v in losses)
              + f"; step {step_ms:.2f} ms (mean of the last "
              f"{FFN_STEPS - 2}); K9 launches on the path: {launches} "
              f"({FFN_STEPS} forward + {FFN_STEPS} backward), plain 0; the "
              f"first step's forward and backward K9 calls "
              f"({list(shape)} bf16 x{f:.4g}) equal the plain version bit "
              f"for bit")
        del model, opt, lin1, lin2, x, y
    finally:
        ptt.ops.deregister_op("custom_scale")
        ptt.ops.deregister_op("gelu_like")

    # (e) cpp_extension.load: host ops on CUDA tensors
    src = REPO / "build" / "chip_smoke" / "my_ops.cc"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(CPP_SOURCE)
    fns = cpp_extension.load(
        "chip_smoke_ext", [str(src)], functions=["softclip", "plus_one"],
        vjps={"softclip": (lambda v: (torch.tanh(v),) * 2,
                           lambda t, gr: ((1.0 - t * t) * gr,))})
    try:
        x = torch.randn(1 << 20, generator=g, device="cuda")
        y = fns["plus_one"](x)
        check(y.device == x.device and y.dtype == torch.float32
              and torch.equal(y, x + 1), "cpp_extension: plus_one != x + 1")
        z = fns["softclip"](x)
        t = torch.tanh(x)
        rel = float(((z - t).abs() / t.abs().clamp_min(1e-30)).max())
        check(z.device == x.device and rel <= 1e-6,
              f"cpp_extension: softclip vs torch.tanh: max rel err {rel}")
        xg = x.clone().requires_grad_()
        zg = fns["softclip"](xg)
        zg.sum().backward()
        check(torch.equal(zg, t) and torch.equal(xg.grad, 1.0 - t * t),
              "cpp_extension: softclip's VJP differs from torch")
        xp = x.clone().requires_grad_()
        yp = fns["plus_one"](xp)
        try:
            yp.sum().backward()
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        check("chip_smoke_ext.plus_one" in raised,
              "cpp_extension: a gradient through plus_one did not raise")
        host_ms = eager_ms(lambda: fns["plus_one"](x), iters=10, reps=5,
                           warmup=2)
        rec.update(cpp_rel_err=rel, cpp_plus_one_ms=host_ms)
        print(f"[custom_op] cpp_extension.load: plus_one == x + 1 and "
              f"softclip within {rel:.3g} of torch.tanh on {x.numel()} "
              f"floats on the card; softclip's VJP matches torch; a "
              f"gradient through plus_one raises; plus_one {host_ms:.3f} ms "
              f"a call (a host round trip by contract)")
    finally:
        ptt.ops.deregister_op("chip_smoke_ext.softclip")
        ptt.ops.deregister_op("chip_smoke_ext.plus_one")
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# continuous batching: the serving core at full width and depth
# ---------------------------------------------------------------------------

CB_SLOTS, CB_PROMPT, CB_BLOCK, CB_CHUNK, CB_NEW = 4, 512, 64, 8, 32
CB_SYSTEM = 256                # the shared system prompt (4 full blocks)
# how far a served request's logits may lie from those of an independent
# B=1 paged forward of the same tokens (cb_teacher_forced), in bf16 ulps
# of the row's largest |logit|. The logits leave a bf16 matmul at the end
# of a bf16 residual stream: another batch or another token count a
# forward (another cuBLAS kernel, another summation order) moves each of
# them by a few ulps: at most 7.5 (Llama-2-7B) and 3.6 (GPT-3 1.3B) on an
# H100, and the bound is about twice that. A served token then scores
# within twice the bound of the independent forward's best (cb_hold)
CB_ROW_ULPS = 16
GS_MS_PER_TOKEN = {"llama": 66.68, "gpt": 50.42}   # PERF.md §5, PR 1


def cb_prompts(vocab):
    """The chat traffic of the [serve_cb_*] phases: 12 prompts from a
    seed; 4 share a 256-token system prompt (tails of 16-96 tokens), 1 is
    the system prompt alone (a full hit with copy-on-write), 7 stand
    alone with 40-480 tokens. The first sharer comes first; the other
    sharers and the full hit come after index 3, once its blocks are
    registered. The first 8 are submitted before the first step, the
    last 4 after the third."""
    rs = np.random.RandomState(29)

    def toks(n):
        return rs.randint(1, vocab, int(n)).astype(np.int64)
    system = toks(CB_SYSTEM)
    share = [np.concatenate([system, toks(rs.randint(16, 97))])
             for _ in range(4)]
    alone = [toks(rs.randint(40, 481)) for _ in range(7)]
    return ([share[0]] + alone[:3] + share[1:] + [system.copy()]
            + alone[3:])


class _TimedGraph:
    """A CUDA graph whose replays each record a pair of CUDA events."""

    def __init__(self, graph, log=None):
        self.graph, self.events, self.log = graph, [], log

    def replay(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))
        if self.log is not None:       # replays of several graphs, in order
            self.log.append((start, end))


def sync_guard(sess):
    """Run the post-dispatch part of the overlapped engine's step() (the
    harvested step's bookkeeping and the next stage: _commit_and_stage,
    _stage_next, _stage_next_spec) under
    torch.cuda.set_sync_debug_mode("error"), so a synchronizing call
    there (a read of the card, a copy from pageable memory) raises.
    Returns {method: calls}, filled as the session runs."""
    calls, depth = {}, [0]
    for name in ("_commit_and_stage", "_stage_next", "_stage_next_spec"):
        calls[name] = 0

        def guarded(*a, _fn=getattr(sess, name), _name=name, **kw):
            calls[_name] += 1
            depth[0] += 1
            if depth[0] == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return _fn(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    torch.cuda.set_sync_debug_mode(0)
        setattr(sess, name, guarded)
    return calls


def staged_returns(sess, step, last_event):
    """One step() of an overlapped session: (the step's result, whether
    it dispatched from a staged plan, whether that replay was still
    running when step() returned). ``last_event()`` gives the end event
    of the newest replay (recorded right after it)."""
    ov = sess._ov.overlapped
    more = step()
    staged = sess._ov.overlapped > ov
    return more, staged, staged and not last_event().query()


def cb_session(model, prefix_cache=True, record=None, **kw):
    """The [serve_cb_*] phases' ContinuousBatchingSession (4 slots,
    prompts up to 512, blocks of 64, chunks of 8). ``record``: a [4, V]
    fp32 buffer on the card into which every token selection copies the
    logits it selects from, inside the programs the session captures
    (so the session is built with its selection wrapped)."""
    from paddle_tpu_torch.inference import serving

    cls = serving.ContinuousBatchingSession
    sess = cls.__new__(cls)
    if record is not None:
        select = cls._select.__get__(sess)

        def recording(lv, live):
            record.copy_(lv)         # inside the graphs: no host read
            return select(lv, live)
        sess._select = recording
    sess.__init__(model, slots=CB_SLOTS, max_prompt_len=CB_PROMPT,
                  kv_block_size=CB_BLOCK, chunk=CB_CHUNK,
                  prefix_cache=prefix_cache, **kw)
    return sess


def _small_state(sess):
    """Every small tensor an admit, a chunk or a verify window writes:
    the lengths, the last tokens, the chunk's tokens and (with
    speculation) the verify ladder's outputs (accepted counts and
    boundary tokens; the host-accept chain or logits and uniforms)."""
    small = [sess._seq_lens, sess._tok_dev, sess._toks_dev]
    ladder = sess._verify_ladder
    if ladder is not None:
        small += [ladder.result, ladder.u, *ladder.out.values()]
    return small


def _generators(sess):
    return [sess._gen] + ([sess._spec_gen] if sess._spec is not None
                          else [])


def pool_tensors(sess):
    """Every tensor of the session's KV pools: a tensor per layer and
    side, or two (the int8 payload and its per-token scales)."""
    from paddle_tpu_torch.inference.serving import _pool_tensors

    return _pool_tensors(sess._kcs, sess._vcs)


def _snapshot(sess):
    """Clones of every tensor an admit, a chunk or a verify window
    writes, and the generators' states."""
    return ([p.clone() for p in pool_tensors(sess)],
            [t.clone() for t in _small_state(sess)],
            [g.get_state() for g in _generators(sess)])


def _restore(sess, snap):
    pools, small, gens = snap
    for p, c in zip(pool_tensors(sess), pools):
        p.copy_(c)
    for t, c in zip(_small_state(sess), small):
        t.copy_(c)
    for g, st in zip(_generators(sess), gens):
        g.set_state(st)


def _program_vs_eager(sess, prog, tag, what):
    """``prog`` (a prepared admit, the decode chunk, or a loaded verify
    window) run eagerly (``prog.body()``) and replayed from its CUDA
    graph from the same state and generator states: equal tokens,
    lengths (and verify outputs) and pool bytes. The session is left as
    one replay leaves it."""
    snap = _snapshot(sess)
    prog.body()
    eager_small = [t.clone() for t in _small_state(sess)]
    changed, written = [], []
    for p, c in zip(pool_tensors(sess), snap[0]):
        m = (p != c).flatten(1).any(1)
        changed.append(m)
        written.append(p[m].clone())
    _restore(sess, snap)
    prog()
    torch.cuda.synchronize()
    check(all(torch.equal(t, e) for t, e in zip(
        _small_state(sess), eager_small)),
        f"{tag}: {what}: graph and eager tokens or lengths differ")
    n_changed = 0
    for p, c, m, w in zip(pool_tensors(sess), snap[0], changed, written):
        check(torch.equal(p[m], w) and torch.equal(p[~m], c[~m]),
              f"{tag}: {what}: graph and eager pool bytes differ")
        n_changed += int(m.sum())
    check(n_changed > 0, f"{tag}: {what} wrote no pool block")
    del snap, written
    return n_changed


def cb_compare_admits(sess, tag):
    """From now on, the first admit at each token-buffer width runs both
    eagerly and from its CUDA graph, from the same state
    (_program_vs_eager), before the run goes on from the replay.
    Returns {width: pool blocks written}, filled as the run goes."""
    checked = {}

    def admit(toks, lens, cow):
        prog = sess._admit_prepare(toks, lens, cow)
        w = toks.shape[1]
        if w in checked:
            prog()
        else:
            checked[w] = _program_vs_eager(sess, prog, tag,
                                           f"the admit of width {w}")
        return sess._tok_dev
    sess._admit = admit
    return checked


def cb_compare_verify(sess, tag):
    """From now on, the first verify window at each width runs both
    eagerly and from its CUDA graph, from the same state
    (_program_vs_eager: tokens, accepted counts, boundary tokens,
    lengths and every pool byte), before the run goes on from the
    replay. Returns {width: pool blocks written}, filled as the run
    goes."""
    checked, dispatch = {}, sess._dispatch_spec_window

    def spy(prog, w, *args):
        if w not in checked:
            real = prog

            def prog():
                checked[w] = _program_vs_eager(
                    sess, real, tag, f"the verify window of width {w}")
        return dispatch(prog, w, *args)
    sess._dispatch_spec_window = spy
    return checked


def cb_eager_programs(sess):
    """Every program of ``sess`` from now on runs eagerly on the card (the
    decode chunk rebuilt so, each admit width built so at its first use):
    the yardstick of a graph-against-eager stream comparison."""
    class Eager:
        graph, device_bytes = None, 0

        def __init__(self, body):
            self.body, self.weights = body, sess._weight_addresses()

        def __call__(self):
            self.body()
    sess._build_program = lambda body, kind, **span: Eager(body)
    sess._build_chunk_program()


def cb_drive(model, prompts, prefix_cache, tag, before_step=None,
             reqs=None, waves=((0, 8), (3, None)), compare_admits=False,
             **sess_kw):
    """Serve ``prompts`` (or ``reqs``, Requests) through a cb_session,
    32 new tokens each, the waves ((step, count), ...) as cb_prompts
    says. before_step(session, step) runs before each step. The kernel
    nodes of the session's decode graph and of each admit graph are read
    after the run (``graph_nodes``, ``admit_nodes``); ``first`` holds each
    request's first-token logits row, as the admit that emitted its
    first token selected from it (a copy the admit graphs make of the
    logits into a static buffer, cb_session's ``record``).
    ``compare_admits``: cb_compare_admits.
    Returns a record of the run (``lv_buf``: the record buffer) and the
    session."""
    from paddle_tpu_torch.inference import serving

    lv_buf = torch.empty(CB_SLOTS, model.cfg.vocab_size, device="cuda")
    sess = cb_session(model, prefix_cache, record=lv_buf, **sess_kw)
    if reqs is None:
        reqs = [serving.Request(i, p, CB_NEW) for i, p in enumerate(prompts)]
    prog = sess._chunk_prog
    check(prog.graph is not None, "the decode chunk was not captured")
    timed = prog.graph = _TimedGraph(prog.graph)
    admit_widths, prepare = [], sess._admit_prepare

    def widths(toks, lens, cow):
        admit_widths.append(toks.shape[1])
        return prepare(toks, lens, cow)
    sess._admit_prepare = widths
    checked = cb_compare_admits(sess, tag) if compare_admits else {}
    guarded = sync_guard(sess)
    first, waiting = {}, list(reqs)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    steps, chunk_steps, staged, bounds = [], [], [0, 0], [0]
    while True:
        for at, count in waves:
            if len(steps) == at:
                for r in waiting[:count]:
                    sess.submit(r)
                waiting = waiting[count:] if count is not None else []
        if before_step is not None:
            n_events = len(timed.events)
            before_step(sess, len(steps))
            del timed.events[n_events:]      # not serving replays
        n_chunks, n_admits, live = (
            sess.stats["chunk_steps"], sess.stats["admit_steps"],
            sum(s.req is not None for s in sess._slots))
        fresh = [r for r in reqs if not r.tokens]
        t0 = time.perf_counter()
        more, from_plan, running = staged_returns(
            sess, sess.step, lambda: timed.events[-1][1])
        dt = time.perf_counter() - t0
        staged[0] += from_plan
        staged[1] += running
        if not more and not waiting:
            break
        steps.append(dt)
        if sess.stats["chunk_steps"] > n_chunks:
            chunk_steps.append((dt, live))
        if sess.stats["admit_steps"] > n_admits:
            bounds.append(len(timed.events))     # a new decode stretch
            for r in fresh:
                slot = [i for i, s in enumerate(sess._slots) if s.req is r]
                if r.tokens and slot:
                    first[r.req_id] = lv_buf[slot[0]].clone()
    out = sess.run()
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    sess._pool.assert_quiescent()
    check(sess._chunk_prog is prog
          and sess._captures == 1 + len(sess._admit_progs),
          f"{tag}: {sess._captures} captures for the decode chunk and "
          f"{len(sess._admit_progs)} admit widths")
    card_ms = [a.elapsed_time(b) for a, b in timed.events]
    busy = stretch_busy(timed.events[a:b] for a, b in
                        zip(bounds, bounds[1:] + [len(timed.events)]))
    check(len(card_ms) == len(chunk_steps) == sess.stats["chunk_steps"],
          f"{len(card_ms)} graph replays for {len(chunk_steps)} chunk "
          f"steps")
    prog.graph = timed.graph
    ov = sess._ov
    check(staged[1] == staged[0],
          f"{tag}: {staged[0] - staged[1]} of {staged[0]} staged decode "
          f"steps returned with their chunk already finished on the card")
    check(not sess._overlap or guarded["_commit_and_stage"] == staged[0],
          f"{tag}: {guarded} post-dispatch calls under sync-debug "
          f"mode for {staged[0]} staged steps")
    onoff = "on" if prefix_cache else "off"
    nodes = dumped_kernel_nodes(prog.graph, f"{tag} chunk {onoff}")
    admit_nodes = {}
    for w, p in sorted(sess._admit_progs.items()):
        check(p.graph is not None, f"{tag}: the admit of width {w} was not "
                                   f"captured")
        admit_nodes[w] = dumped_kernel_nodes(p.graph,
                                             f"{tag} admit {w} {onoff}")
    done = [r for r in reqs if r.status == "done"]
    check(set(first) >= {r.req_id for r in done},
          f"{tag}: first-token rows of {sorted(map(str, first))}")
    ttft = sorted(r.first_tok_t - r.submit_t for r in done)
    return dict(out=out, stats=sess.stats, wall_s=wall, steps=len(steps),
                chunk_host_ms=[1e3 * dt for dt, _ in chunk_steps],
                chunk_live=[n for _, n in chunk_steps],
                chunk_card_ms=card_ms, ttft_s=ttft, graph_nodes=nodes,
                admit_nodes=admit_nodes, admit_widths=admit_widths,
                capture_ms=dict(chunk=1e3 * prog.capture_s, **{
                    str(w): 1e3 * p.capture_s
                    for w, p in sorted(sess._admit_progs.items())}),
                admits_checked=checked, reqs=reqs, lv_buf=lv_buf,
                first={k: v.float().cpu() for k, v in first.items()},
                tokens=sum(len(t) for t in out.values()),
                card_busy_decode_stretches=busy,
                engine=dict(overlap=sess._overlap, steps=ov.steps,
                            overlapped=ov.overlapped,
                            mispredicts=ov.mispredicts,
                            staged_running_at_return=staged[1],
                            sync_guarded=dict(guarded))), sess


def cb_teacher_forced(model, prompt, stream):
    """Logits [len(stream), V] (fp32, on the host) of one B=1 paged
    forward over prompt + stream[:-1] from empty pools: row t scores the
    stream's token t given the prompt and the t tokens before it
    (teacher forcing). No batch, no shared block, no graph."""
    from paddle_tpu_torch.incubate.nn.functional.paged_kv import (
        PagedCache, alloc_block_tables, init_block_cache)
    from paddle_tpu_torch.inference.serving import get_model_adapter

    ad = get_model_adapter(model)
    ids = np.concatenate([prompt, stream[:-1]])
    bt, nb = alloc_block_tables(1, len(ids), CB_BLOCK, device="cuda")
    with torch.inference_mode():
        caches = [PagedCache(*init_block_cache(
            nb, ad.kv_heads, CB_BLOCK, ad.head_dim, ad.dtype,
            device="cuda"), bt, torch.zeros(1, dtype=torch.int32,
                                            device="cuda"), None)
            for _ in range(ad.num_layers)]
        hidden, _ = ad.backbone(torch.as_tensor(ids[None], device="cuda"),
                                caches=caches, pos_offset=0)
        return ad.logits(hidden[0, len(prompt) - 1:]).float().cpu()


def cb_margins(tf, toks, tag, what):
    """Each token of ``toks`` scores within 2 x CB_ROW_ULPS bf16 ulps of
    the best of the teacher-forced logits ``tf`` (cb_teacher_forced) at
    its step. Returns (the worst margin in ulps, tokens not the argmax)."""
    best = tf.max(-1).values
    got = tf.gather(1, torch.as_tensor(toks)[:, None])[:, 0]
    margin = (best - got) / bf16_ulp(tf.abs().max(-1).values)
    bad = torch.nonzero(margin > 2 * CB_ROW_ULPS)[:, 0]
    check(len(bad) == 0,
          f"{tag}: {what} token at step {bad[:1].tolist()} scores "
          f"{margin[bad[:1]].tolist()} ulps under an independent B=1 "
          f"forward's best, bound {2 * CB_ROW_ULPS}; tokens "
          f"{list(toks)}")
    return margin.max().item(), int((best > got).sum())


def cb_hold(model, prompts, runs, tag):
    """Hold every request that finished in each run of ``runs`` {name:
    record} to an independent B=1 forward of its own tokens
    (cb_teacher_forced; ``prompts`` {req_id: prompt}, or a list indexed
    by req_id): its first-token row within CB_ROW_ULPS bf16 ulps of the
    forward's row 0, and each of its tokens scoring within 2 x
    CB_ROW_ULPS ulps of the forward's best at that step (a token the
    session chose from logits within CB_ROW_ULPS of the forward's can
    score no lower). Every step of every request is held, whatever the
    ties. Returns the readings."""
    if not isinstance(prompts, dict):
        prompts = dict(enumerate(prompts))
    forced = {}
    row_ulps, margin_ulps, not_argmax, spread, held = [], [], 0, [], 0
    for name, run in runs.items():
        for rid, toks in run["out"].items():
            if rid not in prompts or len(toks) == 0:
                continue
            p, toks = prompts[rid], np.asarray(toks)
            key = (rid, toks.tobytes())
            if key not in forced:
                forced[key] = cb_teacher_forced(model, p, toks)
            tf = forced[key]
            ulp0 = bf16_ulp(tf[0].abs().max()).item()
            err = (run["first"][rid] - tf[0]).abs().max().item()
            row_ulps.append(err / ulp0)
            check(err <= CB_ROW_ULPS * ulp0,
                  f"{tag}: request {rid} ({name}) first-token logits lie "
                  f"{err:.5f} ({err / ulp0:.1f} ulps) from an independent "
                  f"B=1 forward's, bound {CB_ROW_ULPS} ulps")
            worst, n = cb_margins(tf, toks, tag, f"request {rid} ({name})")
            margin_ulps.append(worst)
            not_argmax += n
            spread.append(tf.std(-1).median().item())
            held += len(toks)
    return dict(row_ulps_max=max(row_ulps), margin_ulps_max=max(margin_ulps),
                tokens_not_argmax=not_argmax, tokens_held=held,
                requests_held=len(row_ulps), forwards=len(forced),
                logit_sd=float(np.median(spread)))


def cb_graph_vs_eager(sess, tag):
    """One decode chunk from the session's current state run eagerly and
    replayed from its CUDA graph: equal tokens, lengths and pool bytes
    (_program_vs_eager). The state is put back afterwards."""
    live = [s.req is not None for s in sess._slots]
    check(any(live), f"{tag}: no live slot to compare a chunk on")
    sess._live_dev.copy_(torch.tensor(live))
    sess._live_up = None         # the next dispatch uploads its own mask
    sess._bt_dev.copy_(torch.from_numpy(sess._bt))
    snap = _snapshot(sess)
    n = _program_vs_eager(sess, sess._chunk_prog, tag, "the decode chunk")
    _restore(sess, snap)
    torch.cuda.synchronize()
    del snap
    return dict(tokens=CB_CHUNK * CB_SLOTS, blocks_written=n)


# TTFT median / p90 ms of the session with eager admits (PERF.md
# section 5, its eager-admit table; NVIDIA H100 80GB HBM3, 700.00 W)
EAGER_ADMIT_TTFT_MS = {"llama": (2024.0, 2790.5), "gpt": (656.1, 859.9)}
CB_SAMPLED = dict(do_sample=True, temperature=0.9, top_k=50)


def cb_serve(model, reqs, eager=False, compare=None, **kw):
    """Serve ``reqs`` through a cb_session (all submitted at once) and
    return its streams: from CUDA graphs, or with ``eager`` every program
    run eagerly (cb_eager_programs); ``compare`` (a tag): the first admit
    at each width checked graph against eager (cb_compare_admits)."""
    sess = cb_session(model, **kw)
    if eager:
        cb_eager_programs(sess)
    checked = cb_compare_admits(sess, compare) if compare else {}
    for r in reqs:
        sess.submit(r)
    out = sess.run()
    sess._pool.assert_quiescent()
    widths = sorted(sess._admit_progs)
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out, checked, widths


def cb_warm_ttft(sess, prompts):
    """The same traffic (cb_prompts' waves) again through a session that
    has served it once, with its prefix cache flushed, so the same admit
    widths run, every one now captured. Returns (TTFT seconds, sorted;
    captures made by this pass)."""
    from paddle_tpu_torch.inference import serving

    sess.flush_prefix_cache()
    captures = sess._captures
    reqs = [serving.Request(1000 + i, p, CB_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs[:8]:
        sess.submit(r)
    steps = 0
    while sess.step() or steps < 3:
        steps += 1
        if steps == 3:
            for r in reqs[8:]:
                sess.submit(r)
    sess.run()
    sess._pool.assert_quiescent()
    return (sorted(r.first_tok_t - r.submit_t for r in reqs),
            sess._captures - captures)


def cb_count_launches(tag, kernel, run, recorded, outside, per_forward,
                      compared=0):
    """The launches of a served run, read from the graphs: the kernel's
    nodes in the session's decode graph (CB_CHUNK forwards) and in each
    admit graph (one forward), the wrapper's calls recorded in those
    captures, and its launches outside them (each capture's warm-up, and
    the ``compared`` admits run eagerly to compare them with their
    graphs, which are not counted as the run's). Returns (the run's
    launches, the kernel's nodes in the decode graph)."""
    fragment = kernel.symbol.replace("ptt_", "") + "_kernel"
    in_graph = sum(fragment in n for n, _ in run["graph_nodes"])
    want = CB_CHUNK * per_forward
    check(in_graph == want, f"{tag}: the chunk graph holds {in_graph} "
                            f"{fragment} launches, want {want}")
    for w, nodes in run["admit_nodes"].items():
        n = sum(fragment in name for name, _ in nodes)
        check(n == per_forward, f"{tag}: the admit graph of width {w} holds "
                                f"{n} {fragment} launches, want "
                                f"{per_forward}")
    captured = want + len(run["admit_nodes"]) * per_forward
    check(recorded == captured,
          f"{tag}: {recorded} wrapper calls recorded in the captures for "
          f"{captured} graph nodes")
    check(outside == captured + compared * per_forward,
          f"{tag}: {outside} launches outside the graphs for the captures' "
          f"warm-ups ({captured}) and {compared} compared admits")
    st = run["stats"]
    launches = (captured + len(run["chunk_card_ms"]) * in_graph
                + st["admit_steps"] * per_forward)
    return launches, in_graph


def _serve_cb(family, kernel):
    """The continuous-batching serving core at full width and depth;
    every norm on ``kernel``; the decode chunk and every admit width
    from CUDA graphs."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.inference import serving
    from paddle_tpu_torch.nn.functional import norm

    tag = f"serve_cb_{family}"
    # sessions are reference cycles: collect the dead ones (an earlier
    # phase's pools and model) before the peak is read from 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serving_model(family)
    per_forward = 2 * model.cfg.num_layers + 1
    vocab = model.cfg.vocab_size
    prompts = cb_prompts(vocab)
    other = (norm.LAYER_NORM_KERNEL if kernel is fused_ops.RMS_NORM_KERNEL
             else fused_ops.RMS_NORM_KERNEL)

    # the main path: prefix cache on, kernel counts from 0
    for k in (kernel, other):
        k.reset_counts()
    on, sess = cb_drive(model, prompts, True, tag)
    outside, recorded, plain = (kernel.launches, kernel.recorded,
                                kernel.plain_calls)
    check(plain == 0, f"{tag}: plain norm ran {plain} times on the card")
    check(other.launches == other.recorded == other.plain_calls == 0,
          f"{tag}: the other norm ran")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    st = on["stats"]
    eng = on["engine"]
    check(eng["overlap"] and eng["overlapped"] > 0,
          f"{tag}: the default engine launched {eng['overlapped']} chunks "
          f"from a staged plan")
    check(set(on["out"]) == set(range(len(prompts))),
          f"{tag}: requests missing from run()")
    for rid, toks in on["out"].items():
        check(len(toks) == CB_NEW and ((toks >= 0) & (toks < vocab)).all(),
              f"{tag}: request {rid} tokens {toks}")
    plen = sum(len(p) for p in prompts)
    check(st["prefill_tokens"] == plen - st["prefix_hit_tokens"],
          f"{tag}: prefill_tokens {st['prefill_tokens']} != {plen} - "
          f"{st['prefix_hit_tokens']}")
    check(st["prefix_hits"] >= 4 and st["prefix_cow"] >= 1,
          f"{tag}: prefix stats {st}")
    PHASE_STREAMS[tag] = on["out"]
    # the overlapped engine's readings, as [serve_overlap_*] reads the
    # sequential engine's on the same traffic
    eng.update(
        ms_per_generated_token=1e3 * on["wall_s"] / on["tokens"],
        card_busy_decode_stretches=on["card_busy_decode_stretches"],
        engine_overlap_fraction=eng["overlapped"] / eng["steps"])
    PHASE_ENGINE[tag] = eng
    widths_used = sorted(set(on["admit_widths"]))
    check(set(widths_used) | {CB_PROMPT} == set(on["admit_nodes"]),
          f"{tag}: admit widths {widths_used}, graphs "
          f"{sorted(on['admit_nodes'])} (width {CB_PROMPT} is captured with "
          f"the session)")
    launches, in_graph = cb_count_launches(tag, kernel, on, recorded,
                                           outside, per_forward)
    replays = len(on["chunk_card_ms"])
    # where a chunk's card time goes: the same chunk run eagerly under
    # the profiler (the graph's kernels, one by one)
    with sess._null_inputs():
        chunk_ms, top = device_breakdown(sess._chunk_body, top=8)
    # TTFT once every admit width the traffic uses is captured; then the
    # same traffic once more, the first admit at each width graph
    # against eager
    warm, warm_captures = cb_warm_ttft(sess, prompts)
    check(warm_captures == 0, f"{tag}: the second pass captured "
                              f"{warm_captures} programs")
    admits_checked = cb_compare_admits(sess, tag)
    cb_warm_ttft(sess, prompts)
    check(set(widths_used) <= set(admits_checked),
          f"{tag}: admit widths {widths_used}, checked graph against eager "
          f"{sorted(admits_checked)}")
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    # prefix cache off, and one chunk of it graph against eager
    ge = {}

    def compare(sess, step):
        if step == 1:                # after the first admit
            ge.update(cb_graph_vs_eager(sess, tag))
    off, sess = cb_drive(model, prompts, False, tag, before_step=compare)
    check(ge, f"{tag}: graph-vs-eager check did not run")
    del sess
    gc.collect()
    torch.cuda.empty_cache()

    # a sampled session (4 requests, cache on, prefill in chunks of 64)
    # from CUDA graphs against the same session with every program
    # eager: the same bytes; its first admit at each width held graph
    # against eager too
    def sampled():
        return [serving.Request(i, p, CB_CHUNK, seed=i)
                for i, p in enumerate(prompts[:4])]
    s_graph, s_checked, s_widths = cb_serve(
        model, sampled(), compare=tag, prefill_chunk=CB_BLOCK, **CB_SAMPLED)
    s_eager, _, _ = cb_serve(model, sampled(), eager=True,
                             prefill_chunk=CB_BLOCK, **CB_SAMPLED)
    check(all(np.array_equal(s_graph[r], s_eager[r]) for r in s_eager)
          and set(s_graph) == set(s_eager),
          f"{tag}: sampled streams from graphs {s_graph} and eager "
          f"{s_eager} differ")
    admits_checked = sorted(set(admits_checked) | set(s_checked))

    # every request of both runs against an independent B=1 forward of
    # its own tokens
    held = cb_hold(model, prompts, {"cache on": on, "cache off": off}, tag)
    same = sum(np.array_equal(on["out"][r], off["out"][r])
               for r in range(len(prompts)))
    torch.cuda.empty_cache()

    host = np.array(on["chunk_host_ms"])
    card = np.array(on["chunk_card_ms"])
    live = np.array(on["chunk_live"])
    ttft = np.array(on["ttft_s"]) * 1e3
    res = dict(
        launches=launches, launches_outside_graph=outside,
        wrapper_calls=outside + recorded, plain_calls=plain,
        graph_launches_per_chunk=in_graph,
        graph_kernel_nodes=len(on["graph_nodes"]),
        admit_graph_widths=sorted(on["admit_nodes"]),
        admit_graph_kernel_nodes={w: len(n) for w, n in
                                  on["admit_nodes"].items()},
        admit_widths_checked=admits_checked,
        capture_ms=on["capture_ms"],
        graph_replays=replays, stats=st, stats_off=off["stats"],
        engine=eng,
        steps=on["steps"], wall_s=on["wall_s"],
        ttft_ms_median=float(np.median(ttft)),
        ttft_ms_p90=float(np.percentile(ttft, 90)),
        ttft_ms_eager_admits=EAGER_ADMIT_TTFT_MS[family],
        ttft_ms_warm_median=1e3 * float(np.median(warm)),
        ttft_ms_warm_p90=1e3 * float(np.percentile(warm, 90)),
        decode_ms_per_token=float(np.median(host)) / CB_CHUNK,
        ms_per_generated_token=float(np.median(host / (CB_CHUNK * live))),
        tokens_per_s=on["tokens"] / on["wall_s"],
        chunk_card_ms=float(np.median(card)),
        chunk_host_ms=float(np.median(host)),
        card_busy=float(np.median(card / host)),
        peak_gb=peak_gb, held=held, row_ulps_bound=CB_ROW_ULPS,
        streams_equal_cache_on_off=int(same),
        eager_chunk_card_ms=chunk_ms, eager_chunk_top_kernels=top,
        graph_vs_eager=ge,
        sampled_graph_vs_eager=dict(requests=len(s_graph),
                                    widths=s_widths),
        wall_s_off=off["wall_s"])
    print(f"[{tag}] {len(prompts)} requests x {CB_NEW} tokens over "
          f"{CB_SLOTS} slots in {on['steps']} steps "
          f"({st['admit_steps']} admits as CUDA graph replays at widths "
          f"{widths_used}, {st['chunk_steps']} chunks of {CB_CHUNK} as CUDA "
          f"graph replays); prefix hits "
          f"{st['prefix_hits']}, hit tokens {st['prefix_hit_tokens']}, CoW "
          f"{st['prefix_cow']}, prefill tokens {st['prefill_tokens']} = "
          f"{plen} - {st['prefix_hit_tokens']}; pool quiescent")
    busy = eng["card_busy_decode_stretches"]
    print(f"[{tag}] overlapped engine (the default): {eng['steps']} steps, "
          f"{eng['overlapped']} chunks launched from a staged plan, each "
          f"still running on the card when step() returned (the "
          f"bookkeeping and staging behind it under sync-debug \"error\": "
          f"{eng['sync_guarded']}), {eng['mispredicts']} mispredicts; "
          f"engine_overlap_fraction {eng['engine_overlap_fraction']:.3f}, "
          f"{eng['ms_per_generated_token']:.3f} ms per generated token "
          f"(wall over tokens, captures inside), card busy over decode "
          f"stretches "
          + ("not measured" if busy is None else f"{100 * busy:.2f}%"))
    print(f"[{tag}] {kernel.symbol}: {launches} launches on the card = "
          f"{outside} outside the graphs (the captures' warm-ups: one chunk "
          f"and one forward per admit width, x {per_forward}) + {replays} "
          f"chunk replays x {in_graph} + {st['admit_steps']} admit replays x "
          f"{per_forward}; the session's own graphs hold {in_graph} = "
          f"{CB_CHUNK} x {per_forward} (chunk) and {per_forward} (each of "
          f"{len(on['admit_nodes'])} admit widths) (the wrapper recorded "
          f"{recorded} calls in the captures), 0 plain, none of the other "
          f"norm")
    print(f"[{tag}] capture host ms (warm-up, recording, instantiation): "
          + ", ".join(f"{k} {v:.1f}" for k, v in on["capture_ms"].items())
          + f" (the chunk and width {CB_PROMPT} with the session, the others "
          f"at their first use, inside the run)")
    print(f"[{tag}] graph vs eager: one chunk from the same state gives "
          f"equal tokens, lengths and pool bytes "
          f"({ge['blocks_written']} blocks written); so does the first "
          f"admit at each of the widths {admits_checked} (a third pass of "
          f"the traffic, and the sampled run); a sampled session "
          f"of {len(s_graph)} requests (widths {s_widths}) streams the same "
          f"bytes from graphs and eagerly")
    print(f"[{tag}] streams: all {held['tokens_held']} tokens of the "
          f"{held['requests_held']} requests (cache on and off) held to an "
          f"independent B=1 paged forward of their own tokens "
          f"({held['forwards']} forwards): first-token rows within "
          f"{held['row_ulps_max']:.1f} bf16 ulps (bound {CB_ROW_ULPS}), "
          f"every token within {held['margin_ulps_max']:.1f} ulps of the "
          f"forward's best (bound {2 * CB_ROW_ULPS}), "
          f"{held['tokens_not_argmax']} not its argmax; median logit sd "
          f"{held['logit_sd']:.3f}; {same} of {len(prompts)} streams equal "
          f"cache on and off")
    print(f"[{tag}] TTFT median {res['ttft_ms_median']:.1f} ms, p90 "
          f"{res['ttft_ms_p90']:.1f} ms with admit graphs, their captures "
          f"inside the run; {res['ttft_ms_warm_median']:.1f} / "
          f"{res['ttft_ms_warm_p90']:.1f} ms on a second pass of the same "
          f"traffic (prefix cache flushed, every width captured) (eager "
          f"admits, PERF.md: {EAGER_ADMIT_TTFT_MS[family][0]} / "
          f"{EAGER_ADMIT_TTFT_MS[family][1]} ms); decode "
          f"{res['decode_ms_per_token']:.3f} ms/token per live slot (chunk "
          f"step / {CB_CHUNK}), "
          f"{res['ms_per_generated_token']:.3f} ms per generated token; "
          f"{res['tokens_per_s']:.1f} tokens/s over the run "
          f"({on['wall_s']:.2f} s; cache off {off['wall_s']:.2f} s); chunk "
          f"card {res['chunk_card_ms']:.2f} ms of host "
          f"{res['chunk_host_ms']:.2f} ms = {100 * res['card_busy']:.1f}% "
          f"(the overlapped engine's step host time does not bracket its "
          f"own replay: busy over decode stretches, above, is the reading "
          f"comparable across engines); peak {peak_gb:.2f} GiB; GenerationSession (PR 1, for "
          f"reference): {GS_MS_PER_TOKEN[family]} ms/token")
    if chunk_ms is None:
        print(f"[{tag}] a chunk's kernels: not measured (the profiler "
              f"recorded no device events)")
    else:
        print(f"[{tag}] a chunk run eagerly under the profiler: card "
              f"{chunk_ms:.2f} ms; top kernels:")
        for t_ in top:
            print(f"[{tag}]   {t_['ms']:9.2f} ms {t_['calls']:6d}x "
                  f"{t_['kernel']}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_cb_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops

    return _serve_cb("llama", fused_ops.RMS_NORM_KERNEL)


def phase_serve_cb_gpt():
    from paddle_tpu_torch.nn.functional import norm

    return _serve_cb("gpt", norm.LAYER_NORM_KERNEL)


def _release_serving_model(family):
    _SERVING_MODELS.pop(family)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# [serve_spec]: speculative decoding on the serving models
# ---------------------------------------------------------------------------

SPEC_K = 4                     # num_draft_tokens (SpeculativeConfig's default)
PHASE_RECORDS = {}      # phase -> its record, for later phases' readings


def spec_drive(model, prompts, spec, tag, waves=((0, 8), (3, None))):
    """Serve ``prompts`` (cb_prompts' waves, 32 new tokens each) through a
    speculative cb_session: no decode chunk, every decode step one verify
    window. Each verify width's graph is timed (CUDA events around its
    replays) and its kernel nodes are read after the run; a draft
    model's engine must hold the target's committed length for every
    live slot after every window. Returns a record of the run and the
    session."""
    from paddle_tpu_torch.inference import serving

    lv_buf = torch.empty(CB_SLOTS, model.cfg.vocab_size, device="cuda")
    sess = cb_session(model, True, record=lv_buf, speculative=spec)
    check(sess._chunk_prog is None and sess._verify_ladder is not None,
          f"{tag}: a speculative session built a decode chunk")
    ladder, timed, order = sess._verify_ladder, {}, []
    build = ladder._build

    def timed_build(body, w):
        prog = build(body, w)
        check(prog.graph is not None,
              f"{tag}: the verify program of width {w} was not captured")
        prog.graph = timed[w] = _TimedGraph(prog.graph, order)
        return prog
    ladder._build = timed_build
    engine = getattr(sess._proposer, "_engine", None)
    draft_timed = []
    if engine is not None:
        get = engine._decode_program

        def timed_program():
            prog = get()
            if not isinstance(prog.graph, _TimedGraph):
                check(prog.graph is not None,
                      f"{tag}: the draft decode step was not captured")
                prog.graph = _TimedGraph(prog.graph)
                draft_timed.append(prog.graph)
            return prog
        engine._decode_program = timed_program
    propose, propose_ms = sess._proposer.propose, []

    def timed_propose(contexts, caps):
        t0 = time.perf_counter()
        out = propose(contexts, caps)
        propose_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    sess._proposer.propose = timed_propose
    # each window's tokens are counted by its own bookkeeping (on the
    # overlapped engine that runs in the step after its dispatch), and
    # the draft engine's lengths are checked right after it
    dispatch, commit = sess._dispatch_spec_window, sess._spec_bookkeeping
    windows, window_of, synced = [], {}, [0]

    def dispatched(*a, **kw):
        inflight = dispatch(*a, **kw)
        window_of[id(inflight)] = len(windows)
        windows.append(dict(width=a[1], tokens=None))
        return inflight

    def committed(inflight, *a, **kw):
        n = commit(inflight, *a, **kw)
        windows[window_of.pop(id(inflight))]["tokens"] = n
        if engine is not None:
            for i, s in enumerate(sess._slots):
                if s.req is not None:
                    check(int(engine.seq[i]) == s.seq_len,
                          f"{tag}: the draft engine holds "
                          f"{int(engine.seq[i])} tokens of slot {i}, the "
                          f"target {s.seq_len}")
                    synced[0] += 1
        return n
    sess._dispatch_spec_window = dispatched
    sess._spec_bookkeeping = committed
    guarded = sync_guard(sess)
    reqs = [serving.Request(i, p, CB_NEW) for i, p in enumerate(prompts)]
    first, waiting, steps, staged = {}, list(reqs), 0, [0, 0]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while True:
        for at, count in waves:
            if steps == at:
                for r in waiting[:count]:
                    sess.submit(r)
                waiting = waiting[count:] if count is not None else []
        st0 = sess.stats
        live = sum(s.req is not None for s in sess._slots)
        n_replays, n_proposed = len(order), len(propose_ms)
        fresh = [r for r in reqs if not r.tokens]
        t0 = time.perf_counter()
        more, from_plan, running = staged_returns(
            sess, sess.step, lambda: order[-1][1])
        dt = time.perf_counter() - t0
        staged[0] += from_plan
        staged[1] += running
        if not more and not waiting:
            break
        steps += 1
        st = sess.stats
        if st["spec_steps"] > st0["spec_steps"]:
            check(len(order) == n_replays + 1,
                  f"{tag}: a window replayed {len(order) - n_replays} "
                  f"verify graphs")
            windows[-1].update(
                host_ms=1e3 * dt, live=live, staged=from_plan,
                propose_ms=(propose_ms[-1] if len(propose_ms) > n_proposed
                            else None), event=order[-1])
        if st["admit_steps"] > st0["admit_steps"]:
            for r in fresh:
                slot = [i for i, s in enumerate(sess._slots) if s.req is r]
                if r.tokens and slot:
                    first[r.req_id] = lv_buf[slot[0]].clone()
    out = sess.run()
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    sess._pool.assert_quiescent()
    done = [r for r in reqs if r.status == "done"]
    check(len(done) == len(reqs) and set(first) >= set(out),
          f"{tag}: {len(done)} of {len(reqs)} requests done")
    check(windows and all(w["tokens"] is not None for w in windows),
          f"{tag}: no speculative window ran, or one was never committed")
    check(staged[1] == staged[0],
          f"{tag}: {staged[0] - staged[1]} of {staged[0]} staged windows "
          f"were finished on the card when step() returned")
    check(not sess._overlap or guarded["_commit_and_stage"] == staged[0],
          f"{tag}: {guarded} post-dispatch calls under sync-debug mode "
          f"for {staged[0]} staged windows")
    for win in windows:
        start, end = win.pop("event")
        win["card_ms"] = start.elapsed_time(end)
    for w, g in timed.items():
        ladder.programs[w].graph = g.graph
    del sess._dispatch_spec_window, sess._spec_bookkeeping
    draft_ms = [a.elapsed_time(b) for g in draft_timed for a, b in g.events]
    if engine is not None:
        check(len(draft_timed) == 1 and len(draft_ms)
              == engine.decode_steps + engine.ingest_steps,
              f"{tag}: {len(draft_timed)} draft decode graphs, "
              f"{len(draft_ms)} replays")
        engine._decode_prog.graph = draft_timed[0].graph
    nodes = dict(
        verify={w: dumped_kernel_nodes(g.graph, f"{tag} verify {w}")
                for w, g in sorted(timed.items())},
        admit={w: dumped_kernel_nodes(p.graph, f"{tag} admit {w}")
               for w, p in sorted(sess._admit_progs.items())},
        draft=None)
    if engine is not None:
        check(engine._decode_prog is not None
              and engine._decode_prog.graph is not None,
              f"{tag}: the draft decode step was not captured")
        check(synced[0] > 0, f"{tag}: no window checked the draft lengths")
        nodes["draft"] = dumped_kernel_nodes(engine._decode_prog.graph,
                                             f"{tag} draft decode")
    return dict(
        out=out, stats=sess.stats, wall_s=wall, steps=steps,
        windows=windows, first={k: v.float().cpu()
                                for k, v in first.items()},
        replays={w: len(g.events) for w, g in timed.items()}, nodes=nodes,
        draft_steps=None if engine is None else engine.decode_steps,
        draft_ingests=None if engine is None else engine.ingest_steps,
        draft_prefills=None if engine is None
        else len(engine.prefill_widths),
        draft_step_card_ms=float(np.median(draft_ms)) if draft_ms
        else None,
        capture_ms={str(w): 1e3 * p.capture_s
                    for w, p in sorted(ladder.programs.items())},
        draft_capture_ms=None if engine is None
        else 1e3 * engine._decode_prog.capture_s,
        ttft_s=sorted(r.first_tok_t - r.submit_t for r in done),
        tokens=sum(len(t) for t in out.values()), synced=synced[0],
        engine=dict(overlap=sess._overlap, steps=sess._ov.steps,
                    overlapped=sess._ov.overlapped,
                    mispredicts=sess._ov.mispredicts,
                    staged_running_at_return=staged[1],
                    sync_guarded=dict(guarded))), sess


def spec_launches(tag, kernel, other, run, outside, recorded, per_forward,
                  draft_per_forward):
    """The norm launches of a speculative run, read from its graphs: each
    verify width's graph and each admit graph hold ``per_forward`` of
    ``kernel``'s nodes and the draft decode graph ``draft_per_forward``,
    none of ``other``'s; the wrapper recorded exactly those nodes in the
    captures, and launched outside them once per capture's warm-up and
    per eager draft prefill. Returns the run's launches: the eager ones,
    plus each graph's replays times its nodes."""
    frag = kernel.symbol.replace("ptt_", "") + "_kernel"
    ofrag = other.symbol.replace("ptt_", "") + "_kernel"
    nodes = run["nodes"]
    graphs = [(f"verify {w}", n, per_forward)
              for w, n in nodes["verify"].items()]
    graphs += [(f"admit {w}", n, per_forward)
               for w, n in nodes["admit"].items()]
    if nodes["draft"] is not None:
        graphs.append(("draft decode", nodes["draft"], draft_per_forward))
    for what, n, want in graphs:
        got = sum(frag in name for name, _ in n)
        bad = sum(ofrag in name for name, _ in n)
        check(got == want and bad == 0,
              f"{tag}: the {what} graph holds {got} {frag} and {bad} "
              f"{ofrag} launches, want {want} and 0")
    captured = sum(want for _, _, want in graphs)
    check(recorded == captured,
          f"{tag}: {recorded} wrapper calls recorded in the captures for "
          f"{captured} graph nodes")
    prefills = (run["draft_prefills"] or 0) * (draft_per_forward or 0)
    check(outside == captured + prefills,
          f"{tag}: {outside} launches outside the graphs for the captures' "
          f"warm-ups ({captured}) and the eager draft prefills ({prefills})")
    draft_replays = (run["draft_steps"] or 0) + (run["draft_ingests"] or 0)
    return (outside + run["stats"]["admit_steps"] * per_forward
            + sum(run["replays"].values()) * per_forward
            + draft_replays * (draft_per_forward or 0))


def spec_case(family, kernel, other, model, prompts, spec, name,
              draft_per_forward=None, full=False):
    """One [serve_spec] case on a serving model: the main run (kernel
    counts from 0), every stream held by cb_hold, the readings; with
    ``full`` also the graph against eager at each verify width and a
    sampled session byte for byte from graphs, eagerly and with host
    accept. TTFT warm on a second pass of the same traffic."""
    tag = f"serve_spec_{family} {name}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    per_forward = 2 * model.cfg.num_layers + 1
    vocab = model.cfg.vocab_size
    for k in (kernel, other):
        k.reset_counts()
    run, sess = spec_drive(model, prompts, spec, tag)
    outside, recorded, plain = (kernel.launches, kernel.recorded,
                                kernel.plain_calls)
    check(plain == 0, f"{tag}: plain norm ran {plain} times on the card")
    check(other.launches == other.recorded == other.plain_calls == 0,
          f"{tag}: the other norm ran")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    launches = spec_launches(tag, kernel, other, run, outside, recorded,
                             per_forward, draft_per_forward)
    st = run["stats"]
    check(set(run["out"]) == set(range(len(prompts))),
          f"{tag}: requests missing from run()")
    for rid, toks in run["out"].items():
        check(len(toks) == CB_NEW and ((toks >= 0) & (toks < vocab)).all(),
              f"{tag}: request {rid} tokens {toks}")
    check(st["spec_steps"] == len(run["windows"]) and st["chunk_steps"] == 0,
          f"{tag}: stats {st}")
    widths = sorted({w["width"] for w in run["windows"]})
    warm, warm_captures = cb_warm_ttft(sess, prompts)
    check(warm_captures == 0, f"{tag}: the second pass captured "
                              f"{warm_captures} programs")
    checked = {}
    if full:
        checked = cb_compare_verify(sess, tag)
        cb_warm_ttft(sess, prompts)
        check(set(widths) <= set(checked),
              f"{tag}: verify widths {widths}, checked graph against eager "
              f"{sorted(checked)}")
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    sampled = None
    if full:
        from paddle_tpu_torch.inference import serving

        def reqs():
            return [serving.Request(i, p, CB_CHUNK, seed=i)
                    for i, p in enumerate(prompts[:4])]
        kw = dict(speculative=spec, prefill_chunk=CB_BLOCK, **CB_SAMPLED)
        s_graph, _, _ = cb_serve(model, reqs(), **kw)
        s_eager, _, _ = cb_serve(model, reqs(), eager=True, **kw)
        os.environ["PADDLE_SPEC_DEVICE_ACCEPT"] = "0"
        try:
            s_host, _, _ = cb_serve(model, reqs(), **kw)
        finally:
            del os.environ["PADDLE_SPEC_DEVICE_ACCEPT"]
        for what, s in (("eagerly", s_eager), ("with host accept", s_host)):
            check(set(s) == set(s_graph)
                  and all(np.array_equal(s_graph[r], s[r]) for r in s),
                  f"{tag}: sampled streams from graphs {s_graph} and "
                  f"{what} {s} differ")
        sampled = len(s_graph)
    held = cb_hold(model, prompts, {name: run}, tag)
    base = PHASE_STREAMS.get(f"serve_cb_{family}", {})
    same = sum(np.array_equal(run["out"][r], base[r]) for r in base)
    cb = PHASE_RECORDS.get(f"serve_cb_{family}", {})
    win = run["windows"]
    host = np.array([w["host_ms"] for w in win])
    card = np.array([w["card_ms"] for w in win])
    toks = np.array([w["tokens"] for w in win])
    live = np.array([w["live"] for w in win])
    ttft = np.array(run["ttft_s"]) * 1e3
    res = dict(
        launches=launches, launches_outside_graph=outside,
        wrapper_calls=outside + recorded, plain_calls=plain,
        verify_widths=widths, verify_replays=run["replays"],
        verify_graph_kernel_nodes={w: len(n) for w, n in
                                   run["nodes"]["verify"].items()},
        draft_graph_kernel_nodes=None if run["nodes"]["draft"] is None
        else len(run["nodes"]["draft"]),
        draft_steps=run["draft_steps"], draft_ingests=run["draft_ingests"],
        draft_prefills=run["draft_prefills"],
        draft_step_card_ms=run["draft_step_card_ms"],
        draft_lengths_checked=run["synced"],
        verify_widths_checked=sorted(checked), stats=st,
        acceptance=st["spec_accepted_tokens"]
        / max(1, st["spec_proposed_tokens"]),
        emitted_per_window=float(toks.sum() / live.sum()),
        verify_card_ms=float(np.median(card)),
        step_host_ms=float(np.median(host)),
        propose_ms=float(np.median([w["propose_ms"] for w in win
                                    if w["propose_ms"] is not None])),
        staged_windows=sum(w["staged"] for w in win),
        engine=run["engine"],
        ms_per_generated_token=float(np.median(host / toks)),
        decode_ms_per_token=float(np.median(host * live / toks)),
        tokens_per_s=run["tokens"] / run["wall_s"],
        serve_cb_ms_per_generated_token=cb.get("ms_per_generated_token"),
        serve_cb_tokens_per_s=cb.get("tokens_per_s"),
        ttft_ms_median=float(np.median(ttft)),
        ttft_ms_p90=float(np.percentile(ttft, 90)),
        ttft_ms_warm_median=1e3 * float(np.median(warm)),
        ttft_ms_warm_p90=1e3 * float(np.percentile(warm, 90)),
        capture_ms=run["capture_ms"],
        draft_capture_ms=run["draft_capture_ms"], peak_gb=peak_gb,
        held=held, streams_equal_serve_cb=int(same),
        streams_compared=len(base), sampled_requests=sampled,
        steps=run["steps"], wall_s=run["wall_s"])
    print(f"[serve_spec] {tag}: {len(prompts)} requests x {CB_NEW} tokens in "
          f"{run['steps']} steps ({st['admit_steps']} admits, "
          f"{st['spec_steps']} verify windows at widths {widths}: "
          f"replays {run['replays']}); proposed "
          f"{st['spec_proposed_tokens']}, accepted "
          f"{st['spec_accepted_tokens']} ({100 * res['acceptance']:.1f}%), "
          f"{res['emitted_per_window']:.3f} tokens emitted a row-window; "
          f"pool quiescent; overlapped engine: {run['engine']['steps']} "
          f"steps, {run['engine']['overlapped']} windows launched from a "
          f"staged plan (each still running on the card when step() "
          f"returned; bookkeeping and staging under sync-debug "
          f"\"error\"), {run['engine']['mispredicts']} mispredicts")
    print(f"[serve_spec] {tag}: {kernel.symbol}: {launches} launches = "
          f"{outside} outside the graphs (captures' warm-ups"
          + ("" if draft_per_forward is None else
             f", {run['draft_prefills']} eager draft prefills")
          + f") + replays; each verify graph holds {per_forward} "
          f"and no other norm"
          + ("" if draft_per_forward is None else
             f", the draft decode graph {draft_per_forward} "
             f"({run['draft_steps']} drafting and {run['draft_ingests']} "
             f"one-token ingest replays; the draft's lengths equal the "
             f"target's at {run['synced']} slot-windows)")
          + ", 0 plain")
    if full:
        print(f"[serve_spec] {tag}: graph vs eager: the first window at "
              f"each width {sorted(checked)} equal (tokens, accepted "
              f"counts, boundaries, lengths, pool bytes); a sampled "
              f"session of {sampled} requests streams the same bytes from "
              f"graphs, eagerly and with PADDLE_SPEC_DEVICE_ACCEPT=0")
    print(f"[serve_spec] {tag}: streams: all {held['tokens_held']} tokens "
          f"held to an independent B=1 forward: first-token rows within "
          f"{held['row_ulps_max']:.1f} bf16 ulps (bound {CB_ROW_ULPS}), "
          f"every token within {held['margin_ulps_max']:.1f} ulps of its "
          f"best (bound {2 * CB_ROW_ULPS}); {same} of {len(base)} streams "
          f"byte-equal to [serve_cb_{family}]'s")
    print(f"[serve_spec] {tag}: verify card {res['verify_card_ms']:.2f} ms "
          f"a window, step host {res['step_host_ms']:.2f} ms (propose "
          f"{res['propose_ms']:.2f}"
          + ("" if run["draft_step_card_ms"] is None else
             f"; a draft step's card {run['draft_step_card_ms']:.2f}")
          + f"); {res['ms_per_generated_token']:.3f} "
          f"ms per generated token ([serve_cb_{family}] "
          f"{cb.get('ms_per_generated_token')}), "
          f"{res['tokens_per_s']:.1f} tokens/s ({cb.get('tokens_per_s')}); "
          f"TTFT cold {res['ttft_ms_median']:.1f} / {res['ttft_ms_p90']:.1f}"
          f" ms, warm {res['ttft_ms_warm_median']:.1f} / "
          f"{res['ttft_ms_warm_p90']:.1f}; capture ms "
          + ", ".join(f"{k} {v:.1f}" for k, v in res["capture_ms"].items())
          + ("" if run["draft_capture_ms"] is None else
             f", draft decode {run['draft_capture_ms']:.1f}")
          + f"; peak {peak_gb:.2f} GiB")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _serve_spec(family, kernel, other):
    """[serve_spec]: the n-gram proposer on the serving model (every
    check), then a draft model: TinyLlama-1.1B for Llama-2-7B (its
    vocabulary, max_seq_len raised to Llama-2-7B's 4096, weights from
    another seed), GPT-3 1.3B as its own draft."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.inference.speculative import SpeculativeConfig
    from paddle_tpu_torch.models import LlamaForCausalLM

    model = serving_model(family)
    prompts = cb_prompts(model.cfg.vocab_size)
    res = {"ngram": spec_case(
        family, kernel, other, model, prompts,
        SpeculativeConfig(num_draft_tokens=SPEC_K), "ngram", full=True)}
    if family == "llama":
        cfg = tinyllama_1p1b()
        cfg.max_seq_len = model.cfg.max_seq_len
        draft = LlamaForCausalLM(cfg, device="cuda", dtype="bfloat16",
                                 generator=seed(4321, "cuda")).eval()
        res["draft"] = spec_case(
            family, kernel, other, model, prompts,
            SpeculativeConfig(num_draft_tokens=SPEC_K, proposer="draft",
                              draft_model=draft), "tinyllama draft",
            draft_per_forward=2 * cfg.num_layers + 1)
        del draft
    else:
        res["draft"] = spec_case(
            family, kernel, other, model, prompts,
            SpeculativeConfig(num_draft_tokens=SPEC_K, proposer="draft",
                              draft_model=model), "self draft",
            draft_per_forward=2 * model.cfg.num_layers + 1)
    res["launches"] = res["ngram"]["launches"] + res["draft"]["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_spec_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_spec("llama", fused_ops.RMS_NORM_KERNEL,
                       norm.LAYER_NORM_KERNEL)


def phase_serve_spec_gpt():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_spec("gpt", norm.LAYER_NORM_KERNEL,
                       fused_ops.RMS_NORM_KERNEL)


# ---------------------------------------------------------------------------
# [serve_overlap]: the overlapped engine against the sequential one, and
# the logprobs=True path, on the serving models
# ---------------------------------------------------------------------------

class _KindTimed:
    """A program's CUDA graph whose replays each record a pair of CUDA
    events into a shared log: (program kind, decode stretch, start,
    end, this program)."""

    def __init__(self, graph, kind, log, stretch):
        self.graph, self.kind, self.log, self.stretch = (graph, kind, log,
                                                         stretch)

    def replay(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.log.append((self.kind, self.stretch[0], start, end, self))


def stretch_busy(stretches):
    """The card's busy share over decode stretches, each a list of the
    (start, end) CUDA events of consecutive decode replays (no admit
    between): the replays' time over the time from the first one's
    start to the last one's end, summed over the stretches of at least
    two replays. The gaps are the card waiting for the host. The same
    reading for either engine."""
    busy = span = 0.0
    for reps in stretches:
        if len(reps) > 1:
            busy += sum(a.elapsed_time(b) for a, b in reps)
            span += reps[0][0].elapsed_time(reps[-1][1])
    return busy / span if span else None


def busy_share(log):
    """stretch_busy over the decode programs' replays (chunks, verify
    windows) of a _KindTimed log, by stretch."""
    by = {}
    for kind, st, start, end, _ in log:
        if kind in ("chunk", "verify"):
            by.setdefault(st, []).append((start, end))
    return stretch_busy(by.values())


def engine_pass(sess, prompts, tag, log, stretch, base, seeds, waves):
    """One pass of ``prompts`` (CB_NEW tokens each, request ids base + i,
    the ``waves``) through ``sess``: each staged step must return with
    its replay still running. Returns the pass's streams, requests,
    wall, tokens, steps, engine counts and the card's busy share over its
    decode stretches (``log``'s replays of the pass)."""
    from paddle_tpu_torch.inference import serving

    reqs = [serving.Request(base + i, p, CB_NEW,
                            **({"seed": i} if seeds else {}))
            for i, p in enumerate(prompts)]
    waiting, steps, staged = list(reqs), 0, [0, 0]
    ov0 = (sess._ov.steps, sess._ov.overlapped, sess._ov.mispredicts)
    n_log, n_prof = len(log), len(sess._stepprof.recent())
    tokens0 = sess.stats["tokens_out"]
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    while True:
        for at, count in waves:
            if steps == at:
                for r in waiting[:count]:
                    sess.submit(r)
                waiting = waiting[count:] if count is not None else []
        admits = sess.stats["admit_steps"]
        more, from_plan, running = staged_returns(
            sess, sess.step, lambda: log[-1][3])
        staged[0] += from_plan
        staged[1] += running
        if not more and not waiting:
            break
        if sess.stats["admit_steps"] > admits:
            stretch[0] += 1
        steps += 1
    out = sess.run()
    wall = time.perf_counter() - t_start
    torch.cuda.synchronize()
    sess._pool.assert_quiescent()
    check(staged[1] == staged[0],
          f"{tag}: {staged[0] - staged[1]} of {staged[0]} staged steps "
          f"returned with their replay already finished on the card")
    ov = [n - n0 for n, n0 in zip((sess._ov.steps, sess._ov.overlapped,
                                   sess._ov.mispredicts), ov0)]
    tokens = sess.stats["tokens_out"] - tokens0
    prof = sess._stepprof.recent()[n_prof:]
    return dict(out=out, reqs=reqs, wall_s=wall, tokens=tokens, steps=steps,
                ov_steps=ov[0], overlapped=ov[1], mispredicts=ov[2],
                staged_running_at_return=staged[1],
                ms_per_generated_token=1e3 * wall / max(1, tokens),
                card_busy=busy_share(log[n_log:]),
                engine_overlap_fraction=ov[1] / ov[0] if ov[0] else 0.0,
                host_ms_hidden=1e-3 * sum(r["plan_ahead_us"] for r in prof),
                host_us_median=float(np.median([r["host_us"] for r in prof]))
                if prof else None)


def engine_drive(model, prompts, tag, kernel, other, per_forward,
                 seeds=False, waves=((0, 8), (3, None)), passes=2, **kw):
    """Serve ``prompts`` (``engine_pass``) through one cb_session built
    with ``kw`` (the engine, speculation, logprobs, sampling): a cold
    pass (its captures inside) and, prefix cache flushed, a warm one
    whose timings are the run's readings (``passes=1``: the cold pass
    alone). Every program replay is timed (CUDA events); the overlapped
    engine's post-dispatch part runs under sync-debug "error".
    ``kernel``'s launches over the passes are counted from 0 and read
    from the graphs: each captured program's graph (every kind and
    width: chunk, admit, raw-logits admit, verify) holds per_forward of
    its nodes (the chunk CB_CHUNK x per_forward) and none of
    ``other``'s, the wrapper recorded exactly those nodes in the
    captures and launched outside them once per capture's warm-up; the
    run's launches are those, plus each replay times the nodes read
    from its program's graph. Returns the passes' records, the
    launches, the nodes, the stats and the step profiler's summary."""
    for k in (kernel, other):
        k.reset_counts()
    sess = cb_session(model, **kw)
    log, stretch, captured = [], [0], []

    def wrap(prog, name):
        if prog.graph is not None and not isinstance(prog.graph, _KindTimed):
            prog.graph = _KindTimed(prog.graph, name.split()[0], log,
                                    stretch)
            captured.append((name, prog.graph))
        return prog
    for name, prog in sess._programs().items():
        wrap(prog, name)
    build = sess._build_program
    sess._build_program = lambda body, kind, **span: wrap(
        build(body, kind, **span),
        " ".join([kind, *(str(v) for v in span.values())]))
    guarded = sync_guard(sess)
    cold = engine_pass(sess, prompts, f"{tag} cold", log, stretch, 0,
                       seeds, waves)
    warm = None
    if passes > 1:
        sess.flush_prefix_cache()
        warm = engine_pass(sess, prompts, f"{tag} warm", log, stretch, 1000,
                           seeds, waves)
    check(kernel.plain_calls == 0, f"{tag}: plain norm ran")
    check(other.launches == other.recorded == other.plain_calls == 0,
          f"{tag}: the other norm ran")
    staged = cold["overlapped"] + (warm["overlapped"] if warm else 0)
    check(not sess._overlap or guarded["_commit_and_stage"] == staged,
          f"{tag}: {guarded} post-dispatch calls under sync-debug mode "
          f"for {staged} staged steps")
    frag = kernel.symbol.replace("ptt_", "") + "_kernel"
    ofrag = other.symbol.replace("ptt_", "") + "_kernel"
    nodes = {}
    for i, (name, timed) in enumerate(captured):
        dump = dumped_kernel_nodes(timed.graph, f"{tag} {name} {i}")
        got = sum(frag in n for n, _ in dump)
        bad = sum(ofrag in n for n, _ in dump)
        want = (CB_CHUNK if timed.kind == "chunk" else 1) * per_forward
        check(got == want and bad == 0,
              f"{tag}: the {name} graph holds {got} {frag} and {bad} "
              f"{ofrag} launches, want {want} and 0")
        nodes[id(timed)] = got
    in_graphs = sum(nodes.values())
    check(kernel.recorded == in_graphs,
          f"{tag}: {kernel.recorded} wrapper calls recorded in the "
          f"captures for {in_graphs} graph nodes")
    check(kernel.launches == in_graphs,
          f"{tag}: {kernel.launches} launches outside the graphs for the "
          f"captures' warm-ups ({in_graphs})")
    replays = {}
    for kind, *_ in log:
        replays[kind] = replays.get(kind, 0) + 1
    launches = kernel.launches + sum(nodes[id(t)] for *_, t in log)
    res = dict(cold=cold, warm=warm or cold, overlap=sess._overlap,
               stats=sess.stats, replays=replays, launches=launches,
               graph_nodes={name: nodes[id(t)] for name, t in captured},
               sync_guarded=dict(guarded),
               profiler=sess._stepprof.summary())
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _streams_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(a[r], b[r]) for r in a)


def _serve_overlap(family, kernel, other):
    """[serve_overlap]: what [serve_cb_*] (the overlapped engine on the
    chat traffic) does not cover. The sequential engine on [serve_cb_*]'s
    traffic, one cold pass as [serve_cb_*]'s run is: its streams are
    [serve_cb_*]'s, byte for byte, and its readings stand beside that
    run's. For GPT the same traffic with the n-gram proposer (verify
    windows, k = SPEC_K) on both engines (Llama-2-7B's random streams
    accept none of its drafts, [serve_spec]); 4 periodic prompts at once
    with it on both engines (the traffic whose windows may stage); and 4
    sampled requests with pinned seeds through the device sampler and
    logprobs=True. Each two-engine or two-sampler run serves its traffic
    twice (engine_drive: cold, then warm): streams byte-equal in both
    passes, the warm pass's ms per generated token, busy share and
    overlap fraction the readings. Timing the two engines against each
    other is tools/engine_ab.py's."""
    from paddle_tpu_torch.inference.speculative import SpeculativeConfig

    tag = f"serve_overlap_{family}"
    gc.collect()
    torch.cuda.empty_cache()
    model = serving_model(family)
    pf = 2 * model.cfg.num_layers + 1
    vocab = model.cfg.vocab_size
    prompts = cb_prompts(vocab)
    rs = np.random.RandomState(41)
    periodic = [np.tile(rs.randint(1, vocab, n), 200)[:2 * CB_BLOCK + 3 * n]
                for n in (5, 7, 4, 6)]
    spec = dict(speculative=SpeculativeConfig(num_draft_tokens=SPEC_K))
    waves = ((0, 8), (3, None))
    runs = {}

    # the chat traffic's decode chunks: the sequential engine against
    # [serve_cb_*]'s overlapped run
    base_tag = f"serve_cb_{family}"
    base, ovl = PHASE_STREAMS[base_tag], PHASE_ENGINE[base_tag]
    seq = runs["decode sequential"] = engine_drive(
        model, prompts, f"{tag} decode sequential", kernel, other, pf,
        waves=waves, passes=1, overlap=False)
    check(not seq["overlap"] and len(base) == len(prompts)
          and _streams_equal(seq["cold"]["out"], base),
          f"{tag}: the sequential engine's decode streams differ from "
          f"[{base_tag}]'s")

    cases = [("ngram", prompts, spec, waves),
             ("ngram periodic", periodic, spec, ((0, None),))]
    if family == "llama":
        del cases[0]
    for case, ps, extra, wv in cases:
        for engine in ("sequential", "overlapped"):
            runs[f"{case} {engine}"] = engine_drive(
                model, ps, f"{tag} {case} {engine}", kernel, other, pf,
                waves=wv, overlap=engine == "overlapped", **extra)
        seq, ovl_run = runs[f"{case} sequential"], runs[f"{case} overlapped"]
        for p in ("cold", "warm"):
            check(_streams_equal(seq[p]["out"], ovl_run[p]["out"])
                  and len(seq[p]["out"]) == len(ps),
                  f"{tag}: {case} streams of the two engines differ ({p})")
        check(seq["stats"] == ovl_run["stats"],
              f"{tag}: {case} stats differ: {seq['stats']} "
              f"{ovl_run['stats']}")
        check(not seq["overlap"] and ovl_run["overlap"],
              f"{tag}: {case}: the engines were not as asked")
    samp = dict(prefill_chunk=CB_BLOCK, **CB_SAMPLED)
    for name, extra in (("device sampler", {}), ("logprobs", dict(
            logprobs=True))):
        runs[name] = engine_drive(model, prompts[:4], f"{tag} {name}",
                                  kernel, other, pf, seeds=True,
                                  waves=((0, None),), **samp, **extra)
    dev, lp = runs["device sampler"], runs["logprobs"]
    lps = []
    for p in ("cold", "warm"):
        check(_streams_equal(dev[p]["out"], lp[p]["out"]),
              f"{tag}: logprobs streams {lp[p]['out']} differ from the "
              f"device sampler's {dev[p]['out']} ({p})")
        for r in lp[p]["reqs"]:
            check(len(r.token_logprobs) == len(r.tokens),
                  f"{tag}: request {r.req_id}: {len(r.token_logprobs)} log "
                  f"p for {len(r.tokens)} tokens")
            lps += r.token_logprobs
    lps = np.asarray(lps)
    check(np.isfinite(lps).all() and (lps <= 0).all(),
          f"{tag}: logprobs not finite and <= 0: {lps}")
    res = {}
    for k, r in runs.items():
        res[k] = dict(
            {p: {f: v for f, v in r[p].items() if f not in ("out", "reqs")}
             for p in ("cold", "warm")},
            stats=r["stats"], replays=r["replays"], launches=r["launches"],
            graph_nodes=r["graph_nodes"],
            overlap=r["overlap"], sync_guarded=r["sync_guarded"],
            profiler_overlap_fraction=r["profiler"]["overlap_fraction"])
    res.update(streams_equal_serve_cb=len(base),
               serve_cb_overlapped=ovl,
               logprob_min=float(lps.min()),
               logprob_median=float(np.median(lps)),
               launches={k: r["launches"] for k, r in runs.items()})

    def busy(x):
        return "not measured" if x is None else f"{100 * x:.2f}%"
    c = runs["decode sequential"]["cold"]
    print(f"[{tag}] decode, sequential engine, one cold pass of "
          f"[{base_tag}]'s traffic: {c['tokens']} tokens in {c['steps']} "
          f"steps, {c['ms_per_generated_token']:.3f} ms per generated "
          f"token ({c['wall_s']:.3f} s), card busy over decode stretches "
          f"{busy(c['card_busy'])}, engine_overlap_fraction 0; "
          f"[{base_tag}]'s overlapped run of the same traffic: "
          f"{ovl['ms_per_generated_token']:.3f} ms per generated token, "
          f"busy {busy(ovl['card_busy_decode_stretches'])}, "
          f"engine_overlap_fraction {ovl['engine_overlap_fraction']:.3f} "
          f"({ovl['overlapped']} staged of {ovl['steps']} steps, "
          f"{ovl['mispredicts']} mispredicts); all {len(base)} streams "
          f"byte-equal; {kernel.symbol} "
          f"{runs['decode sequential']['launches']} launches, 0 plain")
    for k, r in runs.items():
        if k == "decode sequential":
            continue
        c, w = r["cold"], r["warm"]
        host = ("none" if w["host_us_median"] is None
                else f"{w['host_us_median']:.0f}")
        print(f"[{tag}] {k} (overlapped engine {r['overlap']}): warm pass "
              f"{w['tokens']} tokens in {w['steps']} steps, "
              f"{w['ms_per_generated_token']:.3f} ms per generated token "
              f"({w['wall_s']:.3f} s), card busy over decode stretches "
              f"{busy(w['card_busy'])}, engine_overlap_fraction "
              f"{w['engine_overlap_fraction']:.3f} ({w['overlapped']} "
              f"staged of {w['ov_steps']} steps, {w['mispredicts']} "
              f"mispredicts), host ms hidden {w['host_ms_hidden']:.2f}, "
              f"median host us a step {host}; cold pass "
              f"{c['ms_per_generated_token']:.3f} ms per generated token, "
              f"{c['overlapped']} staged, {c['mispredicts']} mispredicts; "
              f"every staged step still running on the card at return; "
              f"{kernel.symbol} {r['launches']} launches, 0 plain")
    nodes = sorted({f"{n} {v}" for r in runs.values()
                    for n, v in r["graph_nodes"].items()})
    print(f"[{tag}] {kernel.symbol} nodes read from every captured graph "
          f"(kind, width, nodes): {', '.join(nodes)}; the wrapper recorded "
          f"those nodes in the captures and launched outside them once per "
          f"capture; none of {other.symbol}")
    print(f"[{tag}] {', '.join(c[0] for c in cases)}: the two engines' "
          f"streams (both passes) and stats byte-equal; "
          f"logprobs=True streams the device sampler's bytes (4 sampled "
          f"requests, pinned seeds, both passes): "
          f"{lp['warm']['ms_per_generated_token']:.3f} ms per generated "
          f"token beside the decode chunk's "
          f"{dev['warm']['ms_per_generated_token']:.3f}; log p finite, "
          f"min {res['logprob_min']:.3f}, median "
          f"{res['logprob_median']:.3f}")
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_serve_overlap_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_overlap("llama", fused_ops.RMS_NORM_KERNEL,
                          norm.LAYER_NORM_KERNEL)


def phase_serve_overlap_gpt():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_overlap("gpt", norm.LAYER_NORM_KERNEL,
                          fused_ops.RMS_NORM_KERNEL)


# [serve_cb_sched]: the scheduler's overload paths on Llama-2-7B
SCHED_CHUNK = 128              # prefill_chunk
SCHED_HI_STEP = 6              # the priority-5 request arrives before it
SCHED_PREEMPT_STEP = 12        # preempt() before it (mid-decode)


def phase_serve_cb_sched():
    return sched_drive("serve_cb_sched")


def sched_drive(tag, kv_dtype=None):
    """Llama-2-7B through the session's overload paths: the cb_prompts
    traffic with prefill_chunk=128 and a pool of half the blocks the 4
    slots' longest requests hold (kv_pool_bytes, in bf16 blocks), a
    request whose deadline passed before its submission, a priority-5
    request that preempts a running one for its slot, and one forced
    preempt() mid-decode. Every finished stream is held by cb_hold (an
    int8 pool, ``kv_dtype``, is not: its logits are another function's);
    the first admit at each width graph against eager; the stats, the
    longest prompt's chunks and the pool's quiescence checked. With
    ``kv_dtype`` the same byte budget holds the int8 geometry's blocks
    (kv_block_bytes), every one of which must be there."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.incubate.nn.functional.paged_kv import (
        kv_block_bytes)
    from paddle_tpu_torch.inference import serving

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serving_model("llama")
    ad = serving.get_model_adapter(model)
    kernel = fused_ops.RMS_NORM_KERNEL
    prompts = dict(enumerate(cb_prompts(model.cfg.vocab_size)))
    prompts["hi"] = np.random.RandomState(31).randint(
        1, model.cfg.vocab_size, 200).astype(np.int64)
    prompts["late"] = prompts[0].copy()
    per_req = -(-(CB_PROMPT + CB_NEW) // CB_BLOCK)
    bf16_blocks = CB_SLOTS * per_req // 2
    budget = bf16_blocks * kv_block_bytes(ad.num_layers, ad.kv_heads,
                                          CB_BLOCK, ad.head_dim,
                                          dtype=ad.dtype)
    blocks = budget // kv_block_bytes(ad.num_layers, ad.kv_heads, CB_BLOCK,
                                      ad.head_dim, dtype=ad.dtype,
                                      kv_dtype=kv_dtype)
    reqs = [serving.Request(i, prompts[i], CB_NEW) for i in range(12)]
    late = serving.Request("late", prompts["late"], CB_NEW, deadline_s=-1.0)
    hi = serving.Request("hi", prompts["hi"], CB_NEW, priority=5)
    longest = max(range(12), key=lambda i: len(prompts[i]))
    seen = dict(chunks=0, forced=None)

    def before(sess, step):
        s = [x for x in sess._slots if x.req is reqs[longest]]
        if s and s[0].pending is not None:
            seen["chunks"] += 1          # the longest prompt prefills now
        if step >= SCHED_PREEMPT_STEP and seen["forced"] is None:
            decoding = [x.req for x in sess._slots if x.req is not None
                        and x.pending is None and x.req is not hi
                        and not x.req.preemptions]
            if decoding:
                seen["forced"] = sess.preempt(decoding[0].req_id)

    kernel.reset_counts()
    run, sess = cb_drive(model, None, True, tag, before_step=before,
                         reqs=[late] + reqs + [hi],
                         waves=((0, 9), (3, 4), (SCHED_HI_STEP, None)),
                         compare_admits=True, prefill_chunk=SCHED_CHUNK,
                         kv_pool_bytes=budget, kv_dtype=kv_dtype)
    st = run["stats"]
    check(sess._num_blocks == blocks, f"{tag}: {sess._num_blocks} blocks "
                                      f"for a budget of {blocks}")
    check(kernel.plain_calls == 0, f"{tag}: plain norm ran")
    launches, _ = cb_count_launches(
        tag, kernel, run, kernel.recorded, kernel.launches,
        2 * model.cfg.num_layers + 1, compared=len(run["admits_checked"]))
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    check(late.status == "expired" and late.tokens == [],
          f"{tag}: the late request is {late.status} with "
          f"{len(late.tokens)} tokens")
    check(seen["forced"] is not None, f"{tag}: preempt() found no victim")
    for r in reqs + [hi]:
        check(r.status == "done" and len(r.tokens) == CB_NEW,
              f"{tag}: request {r.req_id} {r.status} with "
              f"{len(r.tokens)} tokens")
    auto = [r.req_id for r in reqs if r.preemptions
            and r.req_id != seen["forced"]]    # preempted for "hi"
    check(kv_dtype is not None or (st["preemptions"] >= 2 and auto),
          f"{tag}: {st['preemptions']} preemptions, automatic {auto}")
    check(st["expirations"] == 1, f"{tag}: {st['expirations']} expired")
    # its first chunk runs in the step that admits it, the others in
    # steps before which it is mid-prefill
    seen["chunks"] += 1
    need = -(-len(prompts[longest]) // SCHED_CHUNK)
    check(seen["chunks"] >= need and st["admit_steps"] >= need,
          f"{tag}: the {len(prompts[longest])}-token prompt prefilled over "
          f"{seen['chunks']} admits, want >= {need}")
    check(max(run["admit_widths"]) <= SCHED_CHUNK,
          f"{tag}: admit widths {sorted(set(run['admit_widths']))}")
    held = (cb_hold(model, prompts, {"sched": run}, tag) if kv_dtype is None
            else None)
    check(held is None or held["requests_held"] == 13,
          f"{tag}: {held and held['requests_held']} streams held")
    plain = PHASE_STREAMS.get("serve_cb_llama", {})
    equal = sum(np.array_equal(run["out"][i], plain[i])
                for i in range(12) if i in plain)
    preempted = sorted(str(r.req_id) for r in reqs + [hi] if r.preemptions)
    ttft = np.array(run["ttft_s"]) * 1e3
    res = dict(stats=st, num_blocks=blocks, kv_pool_bytes=budget,
               kv_dtype=kv_dtype, bf16_blocks=bf16_blocks,
               launches=launches, forced=seen["forced"], automatic=auto,
               preempted=preempted, longest_prompt=len(prompts[longest]),
               longest_chunks=seen["chunks"],
               admit_widths=sorted(set(run["admit_widths"])),
               admits_checked=sorted(run["admits_checked"]), held=held,
               streams_equal_plain=int(equal), wall_s=run["wall_s"],
               ttft_ms_median=float(np.median(ttft)),
               ttft_ms_p90=float(np.percentile(ttft, 90)),
               peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    print(f"[{tag}] Llama-2-7B, prefill_chunk={SCHED_CHUNK}, kv_pool_bytes "
          f"{budget} = {bf16_blocks} bf16 blocks (half of {CB_SLOTS} slots x "
          f"{per_req}) = {blocks} {kv_dtype or 'bf16'} blocks; "
          f"{len(reqs) + 2} requests in {run['steps']} steps: "
          f"{st['admit_steps']} admits at widths {res['admit_widths']} "
          f"(each width's first admit equal graph vs eager: "
          f"{res['admits_checked']}), {st['chunk_steps']} chunks; "
          f"preemptions {st['preemptions']} (forced {seen['forced']}, "
          f"automatic {auto}; preempted {preempted}), expirations "
          f"{st['expirations']} (late: {late.status}), evictions "
          f"{st['prefix_evictions']}, prefix hits {st['prefix_hits']}; the "
          f"{len(prompts[longest])}-token prompt over {seen['chunks']} "
          f"admits (>= {need}); pool quiescent; {kernel.symbol} {launches} "
          f"launches, 0 plain")
    print(f"[{tag}] streams: "
          + ("not held to a bf16 forward (an int8 pool)" if held is None
             else f"{held['tokens_held']} tokens of {held['requests_held']} "
             f"requests held to an independent B=1 forward: first-token "
             f"rows within {held['row_ulps_max']:.1f} ulps, every token "
             f"within {held['margin_ulps_max']:.1f} ulps of its best "
             f"({held['tokens_not_argmax']} not the argmax)")
          + f"; {equal} of 12 equal to [serve_cb_llama]'s unchunked, "
          f"unpreempted streams; TTFT median {res['ttft_ms_median']:.1f} "
          f"ms, p90 {res['ttft_ms_p90']:.1f} ms; {run['wall_s']:.2f} s; "
          f"peak {res['peak_gb']:.2f} GiB")
    return res


# ---------------------------------------------------------------------------
# [serve_quant]: quantized serving on the serving models
# ---------------------------------------------------------------------------

QUANT_MODES = (("int8", dict(quantize_weights="int8", kv_dtype="int8")),
               ("int4", dict(quantize_weights="int4", kv_dtype="int8")))
# the Linear whose payload the probe zeroes between two chunks
QUANT_PROBE = {"llama": "llama.layers.0.mlp.down_proj.weight",
               "gpt": "gpt.blocks.0.mlp.fc2.weight"}
# the Llama int8 session's peak bound (PERF.md section 6, PR 19's sizing:
# [serve_cb_llama]'s 23.29 GiB - 4.0 (the pool halves) + 6.04 (the int8
# payload) + 1 (one layer's temporaries)); a whole-image dequantization
# would sit about 12 GiB above it
QUANT_PEAK_GB = {"llama": 26.4}


def quant_drive(model, prompts, tag, kernel, other, per_forward, **kw):
    """cb_drive of the [serve_cb_*] traffic through a session built with
    ``kw`` (the quantization knobs), ``kernel``'s counts from 0 and its
    launches read from every graph the session captured (per_forward a
    forward, none of ``other``). Returns (run, session, readings: the
    [serve_cb_*] figures, the memz ledger's weights and pool, the
    pool's blocks, the launches)."""
    from paddle_tpu_torch.observability import memz_snapshot

    for k in (kernel, other):
        k.reset_counts()
    run, sess = cb_drive(model, prompts, True, tag, **kw)
    outside, recorded, plain = (kernel.launches, kernel.recorded,
                                kernel.plain_calls)
    check(plain == 0, f"{tag}: plain norm ran {plain} times on the card")
    check(other.launches == other.recorded == other.plain_calls == 0,
          f"{tag}: the other norm ran")
    launches, in_graph = cb_count_launches(tag, kernel, run, recorded,
                                           outside, per_forward)
    frag = other.symbol.replace("ptt_", "") + "_kernel"
    nodes = run["graph_nodes"] + [
        n for ns in run["admit_nodes"].values() for n in ns]
    check(not any(frag in n for n, _ in nodes),
          f"{tag}: {frag} in the session's graphs")
    host = np.array(run["chunk_host_ms"])
    card = np.array(run["chunk_card_ms"])
    live = np.array(run["chunk_live"])
    mz = memz_snapshot()["providers"][f"serving_session_{id(sess):x}"]
    # where a chunk's card time goes (the dequantizations among it): the
    # same chunk run eagerly under the profiler
    with sess._null_inputs():
        eager_ms, top = device_breakdown(sess._chunk_body, top=6)
    return run, sess, dict(
        eager_chunk_card_ms=eager_ms, eager_chunk_top_kernels=top,
        ms_per_generated_token=float(np.median(host / (CB_CHUNK * live))),
        wall_ms_per_generated_token=1e3 * run["wall_s"] / run["tokens"],
        ttft_ms_median=float(np.median(run["ttft_s"])) * 1e3,
        chunk_card_ms=float(np.median(card)),
        chunk_host_ms=float(np.median(host)),
        weights_bytes=mz["components"]["weights"],
        weights=mz["detail"]["weights"],
        kv_pool_bytes=mz["components"]["kv_pool"],
        kv_pool=mz["detail"]["kv_pool"], num_blocks=sess._num_blocks,
        launches=launches, graph_launches_per_chunk=in_graph,
        admit_graph_widths=sorted(run["admit_nodes"]), stats=run["stats"],
        wall_s=run["wall_s"])


def quant_payload_probe(sess, name, prompt, lv_buf, tag):
    """Between two chunks, nothing in flight: one decode chunk replayed
    from a fixed state with ``name``'s payload as quantized, zeroed, and
    restored. The zeroed payload must change the probe request's tokens
    or logits (nothing serves the bf16 weights behind the payloads); the
    restored one must give the first replay's bytes. The request then
    finishes. Returns the readings."""
    from paddle_tpu_torch.inference import serving

    req = serving.Request("probe", prompt, 4 * CB_CHUNK)
    sess.submit(req)
    while not req.tokens:
        sess.step()                  # the admit that emits its first token
    sess._drain_inflight()
    torch.cuda.synchronize()
    row = [i for i, s in enumerate(sess._slots) if s.req is req]
    check(row and sess._slots[row[0]].pending is None,
          f"{tag}: the probe request is not decoding")
    row = row[0]
    live = [s.req is not None for s in sess._slots]
    sess._live_dev.copy_(torch.tensor(live))
    sess._live_up = None          # the next dispatch uploads its own mask
    sess._bt_dev.copy_(torch.from_numpy(sess._bt))
    q = sess._wq.qvals[name][0]
    kept = q.clone()
    snap = _snapshot(sess)
    outs = []
    for payload in (kept, torch.zeros_like(kept), kept):
        _restore(sess, snap)
        q.copy_(payload)
        sess._chunk_prog()
        torch.cuda.synchronize()
        outs.append((sess._toks_dev[:, row].clone(), lv_buf[row].clone()))
    _restore(sess, snap)
    torch.cuda.synchronize()
    del snap
    toks_changed = not torch.equal(outs[1][0], outs[0][0])
    lv_diff = (outs[1][1] - outs[0][1]).abs().max().item()
    check(toks_changed or lv_diff > 0,
          f"{tag}: zeroing {name}'s payload changed neither the tokens nor "
          f"the logits of a chunk")
    check(torch.equal(outs[2][0], outs[0][0])
          and torch.equal(outs[2][1], outs[0][1]),
          f"{tag}: the restored payload did not give the first chunk's "
          f"tokens and logits back")
    sess.run()
    check(req.status == "done", f"{tag}: the probe request {req.status}")
    return dict(payload=name, tokens_changed=bool(toks_changed),
                logits_max_abs_diff=lv_diff,
                restored_bytes_equal=True)


def quant_image(model, qvals, meta):
    """Write dequantize_weight of a session's payloads (``qvals`` {name:
    (payload, scales)}, kept on the host; ``meta`` {name: (rows, dtype)})
    into ``model``'s quantized Linear weights: the reference's function,
    the session's own group size, on the card."""
    from paddle_tpu_torch.inference.serving import _QUANT_GROUP
    from paddle_tpu_torch.quantization import dequantize_weight

    params = dict(model.named_parameters())
    with torch.no_grad():
        for n, (q, sc) in qvals.items():
            rows, dtype = meta[n]
            dev = params[n].device
            params[n].copy_(dequantize_weight(
                q.to(dev), sc.to(dev), dtype, rows=rows,
                group_size=_QUANT_GROUP))


def _serve_quant(family, kernel, other):
    """[serve_quant]: the [serve_cb_*] chat traffic through quantized
    sessions at full width and depth. (1) int8 and int4 weights over an
    int8 pool: [serve_cb_*]'s figures, peak, the memz ledger, the pool's
    blocks and how many streams equal the bf16 run's (counted, not
    gated: random weights have near-ties). (2) The same traffic through
    an UNQUANTIZED session over an int8 pool whose quantized weights were
    replaced, before it was built, by dequantize_weight of the quantized
    session's payloads: every stream byte-equal. (3) The int8 session:
    a payload zeroed between two chunks changes the chunk, restored gives
    it back (quant_payload_probe). (4) The norm's launches read from
    every graph captured (65 / 49 a forward, none of the other norm);
    for Llama, [serve_cb_sched]'s overload traffic over an int8 pool at
    the same byte budget (sched_drive). Releases the model."""
    tag = f"serve_quant_{family}"
    model = serving_model(family)
    pf = 2 * model.cfg.num_layers + 1
    prompts = cb_prompts(model.cfg.vocab_size)
    base = PHASE_RECORDS[f"serve_cb_{family}"]
    base_streams = PHASE_STREAMS[f"serve_cb_{family}"]
    res, streams, states = {}, {}, {}
    for mode, kw in QUANT_MODES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run, sess, rd = quant_drive(model, prompts, f"{tag} {mode}", kernel,
                                    other, pf, **kw)
        rd["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        rd["streams_equal_bf16"] = int(sum(
            np.array_equal(run["out"][r], base_streams[r])
            for r in base_streams))
        if mode == "int8":
            bound = QUANT_PEAK_GB.get(family)
            check(bound is None or rd["peak_gb"] <= bound,
                  f"{tag}: int8 peak {rd['peak_gb']:.2f} GiB over the "
                  f"sizing's {bound}")
            rd["probe"] = quant_payload_probe(sess, QUANT_PROBE[family],
                                              prompts[1], run["lv_buf"], tag)
        # the payloads wait on the host for their image, so the next mode's
        # peak holds nothing of this one
        wq = sess._wq
        streams[mode], res[mode] = run["out"], rd
        states[mode] = ({n: (q.cpu(), sc.cpu()) for n, (q, sc) in
                         wq.qvals.items()}, dict(wq.meta))
        del run, sess, wq
        gc.collect()
        torch.cuda.empty_cache()

    # the dequantized images: the model's own weights kept aside meanwhile
    params = dict(model.named_parameters())
    kept = {n: params[n].detach().clone() for n in states["int8"][0]}
    for mode, _ in QUANT_MODES:
        quant_image(model, *states[mode])
        run, sess = cb_drive(model, prompts, True, f"{tag} {mode} image",
                             kv_dtype="int8")
        same = [r for r in streams[mode]
                if np.array_equal(run["out"].get(r), streams[mode][r])]
        check(len(same) == len(streams[mode]) == len(prompts)
              and set(run["out"]) == set(streams[mode]),
              f"{tag}: {mode}: {len(same)} of {len(streams[mode])} streams "
              f"equal the dequantized image's")
        res[mode]["image_streams_equal"] = len(same)
        del run, sess
        gc.collect()
        torch.cuda.empty_cache()
    with torch.no_grad():
        for n, t in kept.items():
            params[n].copy_(t)
    del kept, states
    gc.collect()
    torch.cuda.empty_cache()
    if family == "llama":
        res["sched_int8"] = sched_drive(f"{tag} sched int8", kv_dtype="int8")
        check(res["sched_int8"]["num_blocks"] == 35,
              f"{tag}: the int8 pool holds {res['sched_int8']['num_blocks']} "
              f"blocks at 18 bf16 blocks' bytes, want 35")
    res["launches"] = sum(r["launches"] for m, r in res.items()
                          if m in ("int8", "int4")) + (
        res["sched_int8"]["launches"] if "sched_int8" in res else 0)

    for mode, _ in QUANT_MODES:
        r = res[mode]
        w = r["weights"]
        print(f"[{tag}] {mode} weights, int8 pool: "
              f"{r['ms_per_generated_token']:.3f} ms per generated token "
              f"(bf16 [serve_cb_{family}] {base['ms_per_generated_token']:.3f}"
              f"), TTFT cold median {r['ttft_ms_median']:.1f} ms (bf16 "
              f"{base['ttft_ms_median']:.1f}), chunk card / host "
              f"{r['chunk_card_ms']:.2f} / {r['chunk_host_ms']:.2f} ms (bf16 "
              f"{base['chunk_card_ms']:.2f} / {base['chunk_host_ms']:.2f}), "
              f"peak {r['peak_gb']:.2f} GiB (bf16 {base['peak_gb']:.2f}); "
              f"memz weights {r['weights_bytes']} bytes (raw "
              f"{w['raw_bytes']}, quant {w['quant_bytes']}, "
              f"{w['quant_mode']}), kv_pool {r['kv_pool_bytes']} bytes "
              f"({r['kv_pool']['kv_dtype']}), {r['num_blocks']} blocks; "
              f"{r['streams_equal_bf16']} of {len(prompts)} streams equal "
              f"the bf16 run's (counted, not gated); "
              f"{r['image_streams_equal']} of {len(prompts)} byte-equal to "
              f"the unquantized session over the dequantized image; "
              f"{kernel.symbol} {r['launches']} launches ({pf} a forward in "
              f"the chunk graph x {CB_CHUNK} and each of the admit graphs "
              f"{r['admit_graph_widths']}), 0 plain, none of {other.symbol}")
    for mode, _ in QUANT_MODES:
        r = res[mode]
        if r["eager_chunk_card_ms"] is None:
            print(f"[{tag}] {mode}: a chunk's kernels: not measured (the "
                  f"profiler recorded no device events)")
            continue
        print(f"[{tag}] {mode}: a chunk run eagerly under the profiler: card "
              f"{r['eager_chunk_card_ms']:.2f} ms; top kernels:")
        for t_ in r["eager_chunk_top_kernels"]:
            print(f"[{tag}]   {t_['ms']:9.2f} ms {t_['calls']:6d}x "
                  f"{t_['kernel']}")
    pr = res["int8"]["probe"]
    print(f"[{tag}] int8: {pr['payload']}'s payload zeroed between two "
          f"chunks: tokens changed {pr['tokens_changed']}, logits by up to "
          f"{pr['logits_max_abs_diff']:.4f}; restored: the first chunk's "
          f"tokens and logits, byte for byte")
    if "sched_int8" in res:
        q, b = res["sched_int8"], PHASE_RECORDS["serve_cb_sched"]
        print(f"[{tag}] [serve_cb_sched]'s overload traffic over an int8 "
              f"pool at the same {q['kv_pool_bytes']} bytes: "
              f"{q['num_blocks']} blocks (bf16 {b['num_blocks']}), "
              f"preemptions {q['stats']['preemptions']} (bf16 "
              f"{b['stats']['preemptions']}), expirations "
              f"{q['stats']['expirations']} (bf16 "
              f"{b['stats']['expirations']}), {q['stats']['admit_steps']} "
              f"admits, TTFT median {q['ttft_ms_median']:.1f} ms (bf16 "
              f"{b['ttft_ms_median']:.1f})")
    _release_serving_model(family)
    return res


def phase_serve_quant_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_quant("llama", fused_ops.RMS_NORM_KERNEL,
                        norm.LAYER_NORM_KERNEL)


def phase_serve_quant_gpt():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    return _serve_quant("gpt", norm.LAYER_NORM_KERNEL,
                        fused_ops.RMS_NORM_KERNEL)


# [generate_default]: the models' default generate() at full size
GEN_NEW = 32                   # new tokens of the dense and paged loops
GEN_NO_CACHE_NEW = 8           # GPT's use_cache=False


def _generate_default(family, kernel):
    """The family's serving model (B=4, prompt 128, bf16) through
    model.generate with the JAX package's defaults (the dense (k, v)
    cache), GPT's use_cache=False, and the eager paged loop
    (use_paged_kv=True, aot=False); counts from 0 around each; every
    token held to an independent B=1 forward (cb_margins)."""
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    tag = "generate_default"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serving_model(family)
    cfg = model.cfg
    L, per_forward = cfg.num_layers, 2 * cfg.num_layers + 1
    rs = np.random.RandomState(17)
    ids = rs.randint(0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int64)
    kernels = (kernel, fa.FLASH_FWD_KERNEL, fa.FLASH_FWD_FP32_KERNEL)

    def counted(fn):
        for k in kernels:
            k.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        c = {k.symbol: k.launches for k in kernels}
        check(sum(k.plain_calls for k in kernels) == 0,
              f"{tag} {family}: a plain version ran on the card")
        return out, c

    def want(norms, k4):
        return {kernel.symbol: norms, "ptt_flash_fwd": k4,
                "ptt_flash_fwd_fp32": 0}
    runs, launches = {}, {}
    runs["dense"], launches["dense"] = counted(
        lambda: model.generate(ids, max_new_tokens=GEN_NEW))
    check(launches["dense"] == want(per_forward * GEN_NEW, L * GEN_NEW),
          f"{tag} {family}: dense generate launches {launches['dense']}")
    runs["paged eager"], launches["paged eager"] = counted(
        lambda: model.generate(ids, max_new_tokens=GEN_NEW,
                               use_paged_kv=True, aot=False,
                               kv_block_size=BLOCK))
    check(launches["paged eager"] == want(per_forward * GEN_NEW, 0),
          f"{tag} {family}: paged eager launches {launches['paged eager']}")
    prompt_of = {}
    if family == "gpt":
        runs["no cache"], launches["no cache"] = counted(
            lambda: model.generate(ids, max_new_tokens=GEN_NO_CACHE_NEW,
                                   use_cache=False))
        check(launches["no cache"] == want(per_forward * GEN_NO_CACHE_NEW,
                                           L * GEN_NO_CACHE_NEW),
              f"{tag} gpt: no-cache launches {launches['no cache']}")
        # the packed projection's q, k, v views reach K4 at a prompt
        # length off every tile
        ids77 = rs.randint(0, cfg.vocab_size, (2, 77)).astype(np.int64)
        runs["dense S=77"], launches["dense S=77"] = counted(
            lambda: model.generate(ids77, max_new_tokens=4))
        check(launches["dense S=77"] == want(per_forward * 4, L * 4),
              f"{tag} gpt: dense S=77 launches {launches['dense S=77']}")
        prompt_of["dense S=77"] = ids77
    aot = model.generate(ids, max_new_tokens=GEN_NEW, use_paged_kv=True,
                         kv_block_size=BLOCK)
    _, t_1 = sync_time(lambda: model.generate(ids, max_new_tokens=1))
    _, t_n = sync_time(lambda: model.generate(ids, max_new_tokens=GEN_NEW))
    ms_per_token = (t_n - t_1) / (GEN_NEW - 1) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    pre_ms, _ = device_breakdown(lambda: model.generate(ids,
                                                        max_new_tokens=1))
    all_ms, top = device_breakdown(lambda: model.generate(ids,
                                                          max_new_tokens=9))
    busy = step_card = None
    if pre_ms is not None and all_ms is not None:
        step_card = (all_ms - pre_ms) / 8
        busy = step_card / ms_per_token

    forced, worst, not_argmax, held, equal_aot = {}, 0.0, 0, 0, {}
    for path, out in runs.items():
        p_ids = prompt_of.get(path, ids)
        s = p_ids.shape[1]
        gen = out[:, s:].cpu().numpy()
        check(tuple(out.shape) == (p_ids.shape[0], s + gen.shape[1])
              and ((gen >= 0) & (gen < cfg.vocab_size)).all()
              and np.array_equal(out[:, :s].cpu().numpy(), p_ids),
              f"{tag} {family} {path}: output {tuple(out.shape)}")
        if s == PROMPT:
            a = aot[:, s:s + gen.shape[1]].cpu().numpy()
            equal_aot[path] = (int((gen == a).sum()), gen.size)
        for r in range(gen.shape[0]):
            key = (r, s, gen[r].tobytes())
            if key not in forced:
                forced[key] = cb_teacher_forced(model, p_ids[r], gen[r])
            w, n = cb_margins(forced[key], gen[r], f"{tag} {family}",
                              f"{path} row {r}")
            worst, not_argmax, held = max(worst, w), not_argmax + n, (
                held + len(gen[r]))
    res = dict(launches=launches, prefill_ms=t_1 * 1e3,
               ms_per_token=ms_per_token, decode_card_ms=step_card,
               card_busy=busy, peak_gb=peak_gb, tokens_held=held,
               margin_ulps_max=worst, tokens_not_argmax=not_argmax,
               tokens_equal_aot_paged=equal_aot, top_kernels_9_tokens=top)
    print(f"[{tag}] {family}: model.generate(B={BATCH}, S={PROMPT}) dense "
          f"(k, v) cache, {GEN_NEW} tokens: {kernel.symbol} "
          f"{launches['dense'][kernel.symbol]} = {per_forward} x {GEN_NEW}, "
          f"ptt_flash_fwd {launches['dense']['ptt_flash_fwd']} = {L} x "
          f"{GEN_NEW} (the prefill and {GEN_NEW - 1} one-row steps), 0 "
          f"plain; eager paged loop: {launches['paged eager']}"
          + (f"; use_cache=False, {GEN_NO_CACHE_NEW} tokens: "
             f"{launches['no cache']}; dense at S=77 (B=2), 4 tokens: "
             f"{launches['dense S=77']}" if family == "gpt" else ""))
    print(f"[{tag}] {family}: prefill {t_1 * 1e3:.1f} ms, decode "
          f"{ms_per_token:.2f} ms/token (dense), card "
          + (f"{step_card:.2f} ms a step = {100 * busy:.0f}% busy"
             if busy is not None else "not measured (the profiler recorded "
             "no device events)")
          + f"; peak {peak_gb:.2f} GiB; all {held} tokens within "
          f"{worst:.1f} bf16 ulps of an independent B=1 forward's best "
          f"(bound {2 * CB_ROW_ULPS}; {not_argmax} not its argmax); tokens "
          f"equal to the AOT paged stream: "
          + ", ".join(f"{k} {n} of {of}"
                      for k, (n, of) in equal_aot.items()))
    return res


def phase_generate_default_llama():
    from paddle_tpu_torch.incubate.nn.functional import fused_ops

    return _generate_default("llama", fused_ops.RMS_NORM_KERNEL)


def phase_generate_default_gpt():
    from paddle_tpu_torch.nn.functional import norm

    return _generate_default("gpt", norm.LAYER_NORM_KERNEL)


PHASE_STREAMS = {}      # phase -> {req_id: tokens}, for later comparisons
PHASE_ENGINE = {}       # [serve_cb_*] -> its overlapped engine's readings


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (REPO / "paddle_tpu_torch" / "csrc").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    card = phase_card()
    build = phase_build()
    rec = PHASE_RECORDS
    for name, run in (("kernels", phase_kernels), ("llama", phase_llama),
                      ("generate_default_llama",
                       phase_generate_default_llama),
                      ("serve_cb_llama", phase_serve_cb_llama),
                      ("serve_overlap_llama", phase_serve_overlap_llama),
                      ("serve_spec_llama", phase_serve_spec_llama),
                      ("serve_cb_sched", phase_serve_cb_sched),
                      ("serve_quant_llama", phase_serve_quant_llama),
                      ("gpt", phase_gpt),
                      ("generate_default_gpt", phase_generate_default_gpt),
                      ("serve_cb_gpt", phase_serve_cb_gpt),
                      ("serve_overlap_gpt", phase_serve_overlap_gpt),
                      ("serve_spec_gpt", phase_serve_spec_gpt),
                      ("serve_quant_gpt", phase_serve_quant_gpt),
                      ("card_vs_cpu", phase_card_vs_cpu),
                      ("train_kernels", phase_train_kernels),
                      ("train", phase_train),
                      ("train_fused", phase_train_fused),
                      ("train_hm", phase_train_hm),
                      ("train_long", phase_train_long),
                      ("train_llama", phase_train_llama),
                      ("train_recipe", phase_train_recipe),
                      ("train_card_vs_cpu", phase_train_card_vs_cpu),
                      ("custom_op", phase_custom_op)):
        t0 = time.perf_counter()
        rec[name] = run()
        print(f"[{name}] phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
    record = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build["build_s"], build=build, phases=rec,
                  seconds=time.perf_counter() - t_start)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] {record['seconds']:.1f} s")
    kern, train = rec["kernels"], rec["train"]
    tk = rec["train_kernels"]
    fl = "paddle_tpu/incubate/nn/functional/flash_attention.py"
    launches = train["launches"]
    fused = rec["train_fused"]["launches"]
    hm_gpt = rec["train_hm"]["gpt"]["launches"]
    hm_llama = rec["train_hm"]["tinyllama"]["launches"]
    ll = rec["train_llama"]["launches"]
    long = rec["train_long"]["launches"]
    r_gpt = rec["train_recipe"]["gpt"]["launches"]
    r_llama = rec["train_recipe"]["tinyllama"]["launches"]
    g_llama = rec["generate_default_llama"]["launches"]
    g_gpt = rec["generate_default_gpt"]["launches"]
    rows = [
        ("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
         "paddle_tpu/incubate/nn/functional/fused_ops.py:29",
         {"llama2_7b serving": rec["llama"]["launches"],
          "llama2_7b dense generate": g_llama["dense"]["ptt_rms_norm_fwd"],
          "llama2_7b paged eager generate":
              g_llama["paged eager"]["ptt_rms_norm_fwd"],
          "llama2_7b cb serving": rec["serve_cb_llama"]["launches"],
          "llama2_7b cb sched serving": rec["serve_cb_sched"]["launches"],
          "llama2_7b cb quantized serving (int8, int4 weights; sched over "
          "an int8 pool)": rec["serve_quant_llama"]["launches"],
          "llama2_7b spec ngram serving":
              rec["serve_spec_llama"]["ngram"]["launches"],
          "llama2_7b spec tinyllama-draft serving":
              rec["serve_spec_llama"]["draft"]["launches"],
          **{f"llama2_7b cb {k} serving": n for k, n in
             rec["serve_overlap_llama"]["launches"].items()}},
         kern["rms_norm"], kern["rms_norm"]["shapes"][0]),
        ("rms_norm_train", "paddle_tpu_torch/csrc/rms_norm.cu",
         "paddle_tpu/incubate/nn/functional/fused_ops.py:29",
         {"tinyllama train": ll["ptt_rms_norm_fwd"],
          "tinyllama-width hm train": hm_llama["ptt_rms_norm_fwd"],
          "tinyllama recipe train": r_llama["ptt_rms_norm_fwd"]},
         tk["rms_norm_train"], tk["rms_norm_train"]),
        ("layer_norm", "paddle_tpu_torch/csrc/layer_norm.cu",
         "paddle_tpu/nn/functional/norm.py:42",
         {"gpt3_1p3b serving": rec["gpt"]["launches"],
          "gpt3_1p3b dense generate": g_gpt["dense"]["ptt_layer_norm_fwd"]
          + g_gpt["dense S=77"]["ptt_layer_norm_fwd"],
          "gpt3_1p3b no-cache generate":
              g_gpt["no cache"]["ptt_layer_norm_fwd"],
          "gpt3_1p3b paged eager generate":
              g_gpt["paged eager"]["ptt_layer_norm_fwd"],
          "gpt3_1p3b cb serving": rec["serve_cb_gpt"]["launches"],
          "gpt3_1p3b cb quantized serving (int8, int4 weights)":
              rec["serve_quant_gpt"]["launches"],
          "gpt3_1p3b spec ngram serving":
              rec["serve_spec_gpt"]["ngram"]["launches"],
          "gpt3_1p3b spec self-draft serving":
              rec["serve_spec_gpt"]["draft"]["launches"],
          **{f"gpt3_1p3b cb {k} serving": n for k, n in
             rec["serve_overlap_gpt"]["launches"].items()}},
         kern["layer_norm"], kern["layer_norm"]["shapes"][0]),
        ("layer_norm_train", "paddle_tpu_torch/csrc/layer_norm.cu",
         "paddle_tpu/nn/functional/norm.py:42",
         {"gpt3_1p3b train": launches["ptt_layer_norm_fwd"],
          "gpt3_1p3b fused train": fused["ptt_layer_norm_fwd"],
          "gpt3_1p3b-width hm train": hm_gpt["ptt_layer_norm_fwd"],
          "gpt3_1p3b 16K fused train": long["ptt_layer_norm_fwd"],
          "gpt3_1p3b recipe train": r_gpt["ptt_layer_norm_fwd"]},
         tk["layer_norm_train"], tk["layer_norm_train"]),
        ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
         "paddle_tpu/nn/functional/norm.py:106",
         {"gpt3_1p3b train": launches["ptt_layer_norm_bwd"],
          "gpt3_1p3b fused train": fused["ptt_layer_norm_bwd"],
          "gpt3_1p3b-width hm train": hm_gpt["ptt_layer_norm_bwd"],
          "gpt3_1p3b 16K fused train": long["ptt_layer_norm_bwd"],
          "gpt3_1p3b recipe train": r_gpt["ptt_layer_norm_bwd"]},
         tk["layer_norm_bwd"], tk["layer_norm_bwd"]),
        ("flash_fwd", "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
         f"{fl}:769,805",
         {"gpt3_1p3b train": launches["ptt_flash_fwd"],
          "gpt3_1p3b recipe train": r_gpt["ptt_flash_fwd"],
          "gpt3_1p3b no-cache generate": g_gpt["no cache"]["ptt_flash_fwd"]},
         tk["flash_fwd"], tk["flash_fwd"]),
        ("flash_fwd_decode", "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
         f"{fl}:769,805",
         {"llama2_7b dense generate": g_llama["dense"]["ptt_flash_fwd"],
          "gpt3_1p3b dense generate": g_gpt["dense"]["ptt_flash_fwd"]
          + g_gpt["dense S=77"]["ptt_flash_fwd"]},
         tk["flash_fwd_decode"], tk["flash_fwd_decode"]["times"][1]),
        ("flash_bwd", "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
         f"{fl}:873",
         {"gpt3_1p3b train": launches["ptt_flash_bwd"],
          "gpt3_1p3b recipe train": r_gpt["ptt_flash_bwd"]},
         tk["flash_bwd"], tk["flash_bwd"]),
        ("flash_fwd_gqa", "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
         f"{fl}:769,805",
         {"tinyllama train": ll["ptt_flash_fwd"],
          "tinyllama recipe train": r_llama["ptt_flash_fwd"]},
         tk["flash_fwd_gqa"], tk["flash_fwd_gqa"]),
        ("flash_bwd_gqa", "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
         f"{fl}:873,1115",
         {"tinyllama train": ll["ptt_flash_bwd"],
          "tinyllama recipe train": r_llama["ptt_flash_bwd"]},
         tk["flash_bwd_gqa"], tk["flash_bwd_gqa"])]
    for key, sym, src, replaces in (
            ("flash_fwd_hm", "ptt_flash_fwd_hm",
             "paddle_tpu_torch/csrc/flash_fwd_sm90.cu", f"{fl}:135,167"),
            ("flash_bwd_hm", "ptt_flash_bwd_hm",
             "paddle_tpu_torch/csrc/flash_bwd_sm90.cu", f"{fl}:441")):
        rows.append((key, src, replaces,
                     {"gpt3_1p3b fused train": fused[sym],
                      "gpt3_1p3b-width hm train": hm_gpt[sym]},
                     tk[key], tk[key]))
        rows.append((key + "_ramp", src, replaces,
                     {"tinyllama-width hm train": hm_llama[sym]},
                     tk[key + "_ramp"], tk[key + "_ramp"]))
    for key, sym, src, replaces in (
            ("flash_fwd_hm_long", "ptt_flash_fwd_hm",
             "paddle_tpu_torch/csrc/flash_fwd_sm90.cu", f"{fl}:135,167"),
            ("flash_bwd_hm_split", "ptt_flash_bwd_hm_split",
             "paddle_tpu_torch/csrc/flash_bwd_sm90.cu", f"{fl}:349,393")):
        rows.append((key, src, replaces,
                     {"gpt3_1p3b 16K fused train": long[sym]}, tk[key],
                     tk[key]))
    cu = rec["custom_op"]
    for key, path, r, s in (("scale", "register_op", cu, cu["shapes"][0]),
                            ("scale_ffn", "ffn train", cu["ffn"],
                             cu["shapes"][2])):
        rows.append((key, "paddle_tpu_torch/csrc/scale.cu",
                     "tests/test_custom_op.py:101",
                     {path: cu["launches"][path]}, r, s))
    kernels = []
    for name, src, replaces, by_path, r, s in rows:
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"], ms=s["ms"], plain_ms=s["plain_ms"],
            bound_ms=s["bound_ms"], bound_by=s["bound_by"],
            library_ms=s["library_ms"],
            shape=s.get("shape") or f"[{s['rows']}, {s['d']}] {s['dtype']}"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
