#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (paddle_tpu_torch) on one NVIDIA card.

Phases, in order; any failure exits non-zero before the last line:
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
     give identical greedy streams.
  7. training kernels vs plain: LayerNorm backward (K3), flash
     attention forward / backward (K4 / K5), the head-major forward /
     one-pass backward (K6 / K7) and the head-major two-kernel backward
     (K8) against their plain versions at the training steps' shapes
     (GPT-3 1.3B, B=4, S=2048, 16 heads of d=128, and B=1, S=16384;
     TinyLlama-1.1B, B=8, S=2048, 32 heads of d=64 over 4 kv heads, which
     the head-major route sees repeated to 32) and at ragged (Sq < Sk, and
     in bf16 Sq > Sk), d=32, fp32 and grouped-query ones (32:1, 8:2, 8:4,
     4:2), every output held per element; K8 against K7 at S=2048 and
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
Then one JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}. Full records go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py    (from the repository root; one card)
"""
import json
import math
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
        if not str(e.device_type).endswith("CUDA"):
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


def _serve(family, build, kernel, per_forward):
    """Full-width model through the paged-KV serving path."""
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.inference.serving import (
        GenerationSession, get_model_adapter, make_run_model, sample_logits)
    from paddle_tpu_torch.incubate.nn.functional.paged_kv import (
        alloc_block_tables, init_block_cache)
    from paddle_tpu_torch.nn.functional import norm

    torch.cuda.reset_peak_memory_stats()
    model, _t = sync_time(build)
    model.eval()
    cfg = model.cfg
    backbone = model.llama if family == "llama" else model.gpt
    calls = [0]

    def count(_mod, _args):
        calls[0] += 1
    backbone.register_forward_pre_hook(count)

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
    del model, sess, pools, lv, lv2, kcs, vcs
    torch.cuda.empty_cache()
    return res


def phase_llama():
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.models import LlamaForCausalLM, llama2_7b

    cfg = llama2_7b()
    return _serve("llama", lambda: LlamaForCausalLM(
        cfg, device="cuda", dtype="bfloat16", generator=seed(1234, "cuda")),
        fused_ops.RMS_NORM_KERNEL, 2 * cfg.num_layers + 1)


def phase_gpt():
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.functional import norm

    cfg = gpt3_1p3b()
    return _serve("gpt", lambda: GPTForCausalLM(
        cfg, device="cuda", dtype="bfloat16", generator=seed(1234, "cuda")),
        norm.LAYER_NORM_KERNEL, 2 * cfg.num_layers + 1)


def phase_card_vs_cpu():
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.inference.serving import GenerationSession
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
        print(f"[card-vs-cpu] {family}: greedy streams equal "
              f"(fixed and ragged, fp32)")

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
    nodes of a CUDA graph that captures fn() (cudaGraphDebugDotPrint,
    written under build/graphs/). Unlike the profiler, which on the card
    at times records none or only part of a session's kernels, the graph
    holds every launch."""
    import re
    import warnings

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
    del graph
    return {name: tuple(int(x) for x in (grid or one).split(","))
            for name, grid, one in nodes}


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
           timed=3, profile=True, seq=TRAIN_S):
    """``warmup`` and ``timed`` bf16 O2 AdamW steps of ``model`` on one
    batch of [batch, seq] tokens from a seed, through the port's entry
    points. Every kernel of ``path`` must launch ``per_step`` times a step
    with 0 plain calls, every kernel of ``absent`` never; the loss must
    be finite and, over two or more timed steps, fall."""
    import paddle_tpu_torch as ptt

    cfg = model.cfg
    opt = ptt.optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=1e-4, use_multi_tensor=True,
                              multi_precision=True)
    model, opt = ptt.amp.decorate(models=model, optimizers=opt, level="O2",
                                  dtype="bfloat16")
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (REPO / "paddle_tpu_torch" / "csrc").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    card = phase_card()
    build = phase_build()
    rec = {}
    for name, run in (("kernels", phase_kernels), ("llama", phase_llama),
                      ("gpt", phase_gpt), ("card_vs_cpu", phase_card_vs_cpu),
                      ("train_kernels", phase_train_kernels),
                      ("train", phase_train),
                      ("train_fused", phase_train_fused),
                      ("train_hm", phase_train_hm),
                      ("train_long", phase_train_long),
                      ("train_llama", phase_train_llama),
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
    rows = [
        ("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
         "paddle_tpu/incubate/nn/functional/fused_ops.py:29",
         {"llama2_7b serving": rec["llama"]["launches"]},
         kern["rms_norm"], kern["rms_norm"]["shapes"][0]),
        ("rms_norm_train", "paddle_tpu_torch/csrc/rms_norm.cu",
         "paddle_tpu/incubate/nn/functional/fused_ops.py:29",
         {"tinyllama train": ll["ptt_rms_norm_fwd"],
          "tinyllama-width hm train": hm_llama["ptt_rms_norm_fwd"]},
         tk["rms_norm_train"], tk["rms_norm_train"]),
        ("layer_norm", "paddle_tpu_torch/csrc/layer_norm.cu",
         "paddle_tpu/nn/functional/norm.py:42",
         {"gpt3_1p3b serving": rec["gpt"]["launches"]},
         kern["layer_norm"], kern["layer_norm"]["shapes"][0]),
        ("layer_norm_train", "paddle_tpu_torch/csrc/layer_norm.cu",
         "paddle_tpu/nn/functional/norm.py:42",
         {"gpt3_1p3b train": launches["ptt_layer_norm_fwd"],
          "gpt3_1p3b fused train": fused["ptt_layer_norm_fwd"],
          "gpt3_1p3b-width hm train": hm_gpt["ptt_layer_norm_fwd"],
          "gpt3_1p3b 16K fused train": long["ptt_layer_norm_fwd"]},
         tk["layer_norm_train"], tk["layer_norm_train"]),
        ("layer_norm_bwd", "paddle_tpu_torch/csrc/layer_norm_bwd.cu",
         "paddle_tpu/nn/functional/norm.py:106",
         {"gpt3_1p3b train": launches["ptt_layer_norm_bwd"],
          "gpt3_1p3b fused train": fused["ptt_layer_norm_bwd"],
          "gpt3_1p3b-width hm train": hm_gpt["ptt_layer_norm_bwd"],
          "gpt3_1p3b 16K fused train": long["ptt_layer_norm_bwd"]},
         tk["layer_norm_bwd"], tk["layer_norm_bwd"]),
        ("flash_fwd", "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
         f"{fl}:769,805",
         {"gpt3_1p3b train": launches["ptt_flash_fwd"]},
         tk["flash_fwd"], tk["flash_fwd"]),
        ("flash_bwd", "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
         f"{fl}:873",
         {"gpt3_1p3b train": launches["ptt_flash_bwd"]},
         tk["flash_bwd"], tk["flash_bwd"]),
        ("flash_fwd_gqa", "paddle_tpu_torch/csrc/flash_fwd_sm90.cu",
         f"{fl}:769,805",
         {"tinyllama train": ll["ptt_flash_fwd"]},
         tk["flash_fwd_gqa"], tk["flash_fwd_gqa"]),
        ("flash_bwd_gqa", "paddle_tpu_torch/csrc/flash_bwd_sm90.cu",
         f"{fl}:873,1115",
         {"tinyllama train": ll["ptt_flash_bwd"]},
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
