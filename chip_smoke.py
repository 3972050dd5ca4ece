#!/usr/bin/env python3
"""Run the PyTorch + CUDA port (paddle_tpu_torch) on one NVIDIA card.

Phases, in order; any failure exits non-zero before the last line:
  1. card: name and power limit (nvidia-smi); TF32 off for fp32 checks.
  2. build: every CUDA kernel of the port, from the sources in this
     checkout (one nvcc per source, in parallel).
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
Then one JSON line of the kernels, and as the last line
{"ok": true, "device": {...}}. Full records go to chiprun_out/chip_smoke.json.

Usage: python3 chip_smoke.py    (from the repository root; one card)
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
FP32_FLOPS = 67e12             # H100 SXM fp32 rate outside the tensor cores
BATCH, PROMPT, NEW, BLOCK = 4, 128, 64, 64


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
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
    r = ref.float()
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


def phase_build():
    from paddle_tpu_torch import csrc

    t0 = time.perf_counter()
    logs = csrc.build_all()
    secs = time.perf_counter() - t0
    print(f"[build] {len(logs)} of {len(csrc.sources())} kernel libraries "
          f"built in {secs:.2f} s ({', '.join(sorted(logs)) or 'cached'})")
    for name, log in sorted(logs.items()):
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"[build] {name}: {ln.strip()}")
    return secs


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

    # correctness: serving shapes, a rows count that is not a multiple
    # of 8, and a d that takes the scalar (non-vector) path
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
        for rows, d in ((4, 2048), (512, 2048), (77, 2048), (3, 1001)):
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


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (REPO / "paddle_tpu_torch" / "csrc").is_dir():
        fail("run chip_smoke.py from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    t_start = time.perf_counter()
    card = phase_card()
    build_s = phase_build()
    kern = phase_kernels()
    llama = phase_llama()
    gpt = phase_gpt()
    phase_card_vs_cpu()

    sources = {"rms_norm": ("paddle_tpu_torch/csrc/rms_norm.cu",
                            "paddle_tpu/incubate/nn/functional/fused_ops.py:29",
                            llama["launches"]),
               "layer_norm": ("paddle_tpu_torch/csrc/layer_norm.cu",
                              "paddle_tpu/nn/functional/norm.py:42",
                              gpt["launches"])}
    kernels = []
    for name, (src, replaces, launches) in sources.items():
        s = kern[name]["shapes"][0]     # decode shape: most launches
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches, max_abs_err=kern[name]["max_abs_err"],
            ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            rows=s["rows"], d=s["d"], dtype=s["dtype"]))
    record = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s, kernels=kern, llama2_7b=llama,
                  gpt3_1p3b=gpt, seconds=time.perf_counter() - t_start)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] {record['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
