"""Card only: chip_smoke.py's per-element checks of the bf16 attention
kernels, of the LayerNorm backward K3 (``csrc/layer_norm_bwd.cu``) and of
K9 (``csrc/scale.cu``) against their plain versions reject broken
kernels, and the kernels give the same bytes on every call: the
forward K4 (entry ``ptt_flash_fwd``, the warpgroup kernel of
``csrc/flash_fwd_sm90.cu``, which K6 shares), and the backwards K5
(native layout, entry ``ptt_flash_bwd``), K7 (head-major one-pass, entry
``ptt_flash_bwd_hm``) and K8 (head-major two-kernel, entry
``ptt_flash_bwd_hm_split``), all three on the warpgroup kernels of
``csrc/flash_bwd_sm90.cu``.

Copies of ``paddle_tpu_torch``, each with one edit to one of those
sources, are built in a temporary directory and run causal, bf16, at
the GPT-3 1.3B training step's shape (B=4, S=2048, H=16, D=128; K4 and K5
read a packed qkv, K7 head-major [B*H,S,D]) or at TinyLlama-1.1B's (B=8,
S=2048, 32 heads of D=64: K4 and K5 over 4 kv heads, K7 on the ramp's k,
v repeated to the 32 heads). The K4 edits, held on out and lse: the last
live kv tile of each q tile skipped (out, lse), the causal mask one key
late on the diagonal (out, lse), lse written without log(l) (lse only),
and, grouped, q head h reading kv head h % KVH in place of h / (H / KVH)
(out, lse: lse depends on k too). The K5 edits, on the kv and dq kernels
at native strides: a kv-tile CTA of the kv kernel that returns at once,
every kv CTA dropping the terms of the last q tile, dV skipping the q
tile at row 1024, the dq kernel skipping the kv tile at 1024, and,
grouped, the kv kernel dropping the last q head of each kv head's group
and the CTAs of kv head 1 returning at once. The K7 edits: the
ordered dq add of the middle kv tile dropped (it adds 0 in place of its
partial), the last q tile's terms dropped, dk left unscaled, the causal
start of each kv tile's q tiles one tile late, and the last live kv tile
of each q tile never writing dq (it adds into the scratch like the
others).
The K8 edits, run head-major at GPT-3 1.3B's shape (B*H = 64 heads,
S=2048) or at the long step's (2 heads of D=128 at S=16384): the dq
kernel skipping the kv tile at 1024, the kv (dk/dv) kernel starting each
kv tile's q tiles one tile late, and the dq kernel's kv loop stopping at
key 8192 (only the long shape has keys past it). Each copy must fail
the check in exactly the outputs it breaks, and the committed kernels
must pass it at their shapes; an edit whose text is not in its source
exactly once fails its test. Each test prints its worst |kernel -
plain| / tolerance per output. Two forward calls of the committed K4 on
the same inputs must give equal out and lse bytes, and two backward calls
of a committed backward equal dq, dk and dv bytes. K3 is held on dx, dw
and db at chip_smoke's LN_BWD_CASES (bf16 and fp32; outputs NaN-filled
first, so an unwritten element fails): copies whose cp.async-ring kernel
skips the last row of each CTA's run (dx, dw, db), whose pass 2 drops the
last part's partials (dw, db) or whose ring kernel sums g into dw in
place of g * x^ (dw) must fail exactly those outputs, and two calls at
[8192, 2048] bf16 must give equal dx, dw and db bytes. K9 is held bit for
bit at chip_smoke's [custom_op] cases; a copy without its scalar tail must
fail exactly the cases that have one (n = 1, n = 4097 and a view offset
by one element), and a copy that never stores a thread's last vector in
flight exactly the cases with more than (kVecsInFlight - 1) * kThreads
vectors. The continuous-batching session (``cb`` tests, tiny fp32
models): its decode chunk captured as a CUDA graph serves the CPU
session's greedy streams; a sampled session's graph draws from the
session's generator registered with it (one chunk replayed equals the
same chunk run eagerly from the same generator state; sampled streams
equal with the prefix cache on and off); a session built while dead
sessions await the garbage collector still captures its graph; 40
sampled sessions in a row all capture theirs and serve on the
overlapped engine (the count of failures is printed); weights replaced
mid-decode with nothing queued re-capture the graph, which then serves
the CPU session's streams with the same replacement, under both engines
(the overlapped one with the chunk before the swap in flight); the two
engines stream the same sampled bytes (decode and n-gram verify
windows); logprobs=True streams the device sampler's bytes at chunk 1
and 4. The training recipe's options (``recipe`` tests): 2-layer
bf16 models at GPT-3 1.3B's and TinyLlama-1.1B's widths give the same
loss and gradient bytes with and without recompute (through K4/K5, K4
run twice a layer with it); stochastic rounding on the card is
unbiased within 5 standard errors and exact on representable values;
dropout keeps 1 - p within 5 binomial standard deviations; one step of
chip_smoke's [train_recipe] plan at 2 layers launches the expected
kernels (counted by the wrappers, no plain call). The
tests skip without a card; on a machine with one (the
tests' conftest.py sets up JAX, which these tests do not use):

    python -m pytest --noconftest -m card tests/test_torch_card_checks.py -q -s
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
CSRC = Path("paddle_tpu_torch") / "csrc"
# kernel -> its source
SOURCES = {"k4": CSRC / "flash_fwd_sm90.cu", "k5": CSRC / "flash_bwd_sm90.cu",
           "k7": CSRC / "flash_bwd_sm90.cu", "k8": CSRC / "flash_bwd_sm90.cu",
           "k9": CSRC / "scale.cu", "k3": CSRC / "layer_norm_bwd.cu"}
# the committed libraries an edited copy keeps (the forward serves every
# backward check), unless its edit is to one of them
KEPT = ("flash_fwd_sm90.cu",)
COMMITTED = "committed"
# name -> (B, S, H, KVH, D); H == KVH runs K5 on the packed [B,S,3E]
# layout; K7 and K8 take KVH == H ([B*H,S,D] q, k, v)
SHAPES = {"gpt": (4, 2048, 16, 16, 128), "tinyllama": (8, 2048, 32, 4, 64),
          "tinyllama_ramp": (8, 2048, 32, 32, 64),
          "long": (1, 16384, 2, 2, 128)}

_KV_LIVE = ("        const bool live = kv < sk && qr < sq && "
            "(!causal || kv <= qr + off);\n")
# name -> (source text, its replacement, the gradients that must fail,
# the shape it runs at, the kernel it edits)
MUTANTS = {
    # K4 (bf16 forward): csrc/flash_fwd_sm90.cu; the outputs are out, lse
    "k4_last_kv_tile_skipped": (
        "  const int n_kv = sched.kv_last(q0, kTQ, kTK) + 1;  // live kv tiles\n",
        "  const int n_kv = sched.kv_last(q0, kTQ, kTK);\n",
        {"out", "lse"}, "gpt", "k4"),
    "k4_causal_mask_off_by_one": (
        "        if (col >= sk || (causal && col > row + off)) "
        "s_acc[e] = -INFINITY;\n",
        "        if (col >= sk || (causal && col > row + off + 1)) "
        "s_acc[e] = -INFINITY;\n",
        {"out", "lse"}, "gpt", "k4"),
    "k4_lse_without_log_l": (
        "          m_safe * kLn2 + logf(lsafe);\n",
        "          m_safe * kLn2;\n",
        {"lse"}, "gpt", "k4"),
    "k4_gqa_reads_kv_head_h_mod_kvh": (
        "  const int64_t kvoff = L.kv.at(b, h / rep);  // the shared kv head\n",
        "  const int64_t kvoff = L.kv.at(b, h % (heads / rep));\n",
        {"out", "lse"}, "tinyllama", "k4"),
    # K5 (bf16): csrc/flash_bwd_sm90.cu's kv and dq kernels at native
    # strides
    "kv_tile_dropped": (
        "  const int k0 = j * kTK;\n",
        "  const int k0 = j * kTK;\n"
        "  if (j == static_cast<int>(gridDim.x) / 2) return;\n",
        {"dk", "dv"}, "gpt", "k5"),
    "last_q_tile_skipped": (
        _KV_LIVE,
        _KV_LIVE.replace(");\n", ") && i != nq - 1;\n"),
        {"dk", "dv"}, "gpt", "k5"),
    "dv_skips_q_tile_1024": (
        "      wgmma_rs<1>(dv_acc, pa[s], desc_mn<D, kTQ>(sdO, 16 * s, 0), 1);\n",
        "      if (q0 != 1024) {\n"
        "        wgmma_rs<1>(dv_acc, pa[s], desc_mn<D, kTQ>(sdO, 16 * s, 0), "
        "1);\n      }\n",
        {"dv"}, "gpt", "k5"),
    "dq_skips_kv_tile_1024": (
        "        const bool keep = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off);\n",
        "        const bool keep = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off) && k0 != 1024;\n",
        {"dq"}, "gpt", "k5"),
    "gqa_last_q_head_skipped": (
        _KV_LIVE,
        _KV_LIVE.replace(");\n", ") && hr != rep - 1;\n"),
        {"dk", "dv"}, "tinyllama", "k5"),
    "gqa_kv_head_cta_returns": (
        "  const int k0 = j * kTK;\n",
        "  const int k0 = j * kTK;\n"
        "  if (kh == 1) return;\n",
        {"dk", "dv"}, "tinyllama", "k5"),
    # K7 and K8 (bf16): csrc/flash_bwd_sm90.cu
    "k7_dq_add_of_kv_tile_dropped": (
        "          const float2 part =\n"
        "              make_float2(q_acc[4 * c + 2 * h], "
        "q_acc[4 * c + 2 * h + 1]);\n",
        "          const float2 part =\n"
        "              j == static_cast<int>(gridDim.x) / 2\n"
        "                  ? make_float2(0.f, 0.f)\n"
        "                  : make_float2(q_acc[4 * c + 2 * h], "
        "q_acc[4 * c + 2 * h + 1]);\n",
        {"dq"}, "gpt", "k7"),
    "k7_last_q_tile_skipped": (
        "        const bool live = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off);\n",
        "        const bool live = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off) && i != nq - 1;\n",
        {"dq", "dk", "dv"}, "gpt", "k7"),
    "k7_dk_unscaled": (
        "      st_bf16x2(dk + at, dk_acc[4 * c + 2 * h] * scale,\n"
        "                dk_acc[4 * c + 2 * h + 1] * scale);\n",
        "      st_bf16x2(dk + at, dk_acc[4 * c + 2 * h],\n"
        "                dk_acc[4 * c + 2 * h + 1]);\n",
        {"dk"}, "gpt", "k7"),
    "k7_causal_start_one_tile_late": (
        "  const int i_lo = sched.q_first(j, kTK, kTQ);\n",
        "  const int i_lo = sched.q_first(j, kTK, kTQ) + (causal && j > 0);\n",
        {"dq", "dk", "dv"}, "gpt", "k7"),
    "k7_last_kv_tile_never_writes_dq": (
        "      const bool last = j == sched.kv_last(q0, kTQ, kTK);\n",
        "      const bool last = false;\n",
        {"dq"}, "gpt", "k7"),
    "k8_dq_skips_kv_tile_1024": (
        "        const bool keep = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off);\n",
        "        const bool keep = kv < sk && qr < sq && "
        "(!causal || kv <= qr + off) && k0 != 1024;\n",
        {"dq"}, "gpt", "k8"),
    "k8_dkdv_causal_start_one_tile_late": (
        "  const int i_lo = sched.q_first(j, kTK, kTQ);\n",
        "  const int i_lo = sched.q_first(j, kTK, kTQ) + (causal && j > 0);\n",
        {"dk", "dv"}, "gpt", "k8"),
    "k8_dq_kv_loop_stops_at_8192": (
        "  const int n_kv = kv_end;\n",
        "  const int n_kv = min(kv_end, 8192 / kTK);\n",
        {"dq"}, "long", "k8"),
    # K9 without its scalar tail: the cases whose length leaves one
    # (n = 1, n = 4097, the offset view) must fail, and no other
    "k9_tail_dropped": (
        "  if (tid < n - t0) {\n",
        "  if (false && tid < n - t0) {\n",
        set(), None, "k9"),
    # K9 never storing its last vector in flight: the cases with more
    # than (kVecsInFlight - 1) * kThreads vectors must fail, and no other
    "k9_last_vector_in_flight_not_stored": (
        "      if (full || i < nvec) __stcs(yv + i, raw[u]);\n",
        "      if ((full || i < nvec) && u != kVecsInFlight - 1) "
        "__stcs(yv + i, raw[u]);\n",
        set(), None, "k9"),
    # K3 (csrc/layer_norm_bwd.cu), held on dx, dw and db at chip_smoke's
    # LN_BWD_CASES: the cp.async-ring kernel skipping the last row of each
    # CTA's run (dx, and dw / db lose its terms), pass 2 dropping the last
    # part's partials (dw, db), and the ring kernel adding g in place of
    # g * x^ into dw (dw alone)
    "k3_last_row_of_each_run_skipped": (
        "  for (int64_t r = first; r < end; ++r) {\n",
        "  for (int64_t r = first; r < end - 1; ++r) {\n",
        {"dx", "dw", "db"}, None, "k3"),
    "k3_last_partial_dropped": (
        "    for (int64_t p = threadIdx.y; p < n_parts; p += kRedSplit) {\n",
        "    for (int64_t p = threadIdx.y; p < n_parts - 1; p += kRedSplit) "
        "{\n",
        {"dw", "db"}, None, "k3"),
    "k3_dw_sums_g": (
        "        adw[e] += gf[e] * xh;\n",
        "        adw[e] += gf[e];\n",
        {"dw"}, None, "k3"),
}
# test id -> (copy, kernel, shape)
RUNS = {COMMITTED + "_k4": (COMMITTED, "k4", "gpt"),
        COMMITTED + "_k4_gqa": (COMMITTED, "k4", "tinyllama"),
        COMMITTED: (COMMITTED, "k5", "gpt"),
        COMMITTED + "_gqa": (COMMITTED, "k5", "tinyllama"),
        COMMITTED + "_k7": (COMMITTED, "k7", "gpt"),
        COMMITTED + "_k7_ramp": (COMMITTED, "k7", "tinyllama_ramp"),
        COMMITTED + "_k8": (COMMITTED, "k8", "gpt"),
        COMMITTED + "_k8_long": (COMMITTED, "k8", "long"),
        COMMITTED + "_k3": (COMMITTED, "k3", None),
        **{n: (n, m[4], m[3]) for n, m in MUTANTS.items()}}

# Run with the package's copy as the working directory and the repository
# root as argv[1] (for chip_smoke), then the kernel (k4, k5, k7 or k8) and
# B S H KVH D. k4: the forward twice, chip_smoke's check of out and lse
# batch element by batch element, and whether the two calls gave the same
# bytes. Else: the forward then the backward twice, chip_smoke's check of
# dq, dk and dv (K5 batch element by batch element, K7 and K8 sixteen
# heads at a time, one at a time past S=8192: the plain version holds S^2
# fp32 a head), and whether the two backward calls gave the same bytes.
_CHECK = r"""
import json, os, sys
import torch
sys.path.insert(1, sys.argv[1])
import chip_smoke as cs
from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
assert fa.__file__.startswith(os.getcwd()), fa.__file__
torch.backends.cuda.matmul.allow_tf32 = False


class Failed(Exception):
    pass


def _raise(msg):
    raise Failed(msg)


cs.fail = _raise
kernel = sys.argv[2]
b, s, h, kvh, d = (int(a) for a in sys.argv[3:8])
g = torch.Generator(device="cuda").manual_seed(3)


def rand(*shape):
    return torch.randn(*shape, generator=g, device="cuda").bfloat16()


if kernel == "k4":
    if kvh == h:
        q, k, v = cs._packed(rand(b, s, 3 * h * d))
    else:
        q = rand(b, s, h * d)
        k, v = (rand(b, s, kvh * d) for _ in range(2))
    dout = rand(b, s, h * d)
    out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
    again = fa.flash_fwd_cuda(q, k, v, h, True)
    torch.cuda.synchronize()
    res = {n: {"pass": True, "worst_err_over_tol": 0.0} for n in ("out", "lse")}
    res["same_bytes"] = all(torch.equal(x.view(torch.int8), y.view(torch.int8))
                            for x, y in zip((out, lse), again))
    for i in range(b):
        sl = slice(i, i + 1)
        rout, rlse = fa._nl_forward_ref(q[sl], k[sl], v[sl], h, True)
        t = cs._attention_terms(q[sl], k[sl], v[sl], rout, rlse, dout[sl], h,
                                True)[0]
        try:
            cs._check_close(out[sl], rout, "out", t)
        except Failed:
            res["out"]["pass"] = False
        ratio = (out[sl].float() - rout.float()).abs() / cs._close_tol(rout, t)
        res["out"]["worst_err_over_tol"] = max(
            res["out"]["worst_err_over_tol"], float(ratio.max()))
        tol = 1e-5 * max(1.0, float(rlse.abs().max()))
        err = float((lse[sl] - rlse).abs().max())
        res["lse"]["pass"] &= err <= tol
        res["lse"]["worst_err_over_tol"] = max(
            res["lse"]["worst_err_over_tol"], err / tol)
    print(json.dumps(res))
    sys.exit(0)
if kernel in ("k7", "k8"):
    bwd, bwd_ref = ((fa.flash_bwd_hm_cuda, fa._hm_backward_ref)
                    if kernel == "k7" else
                    (fa.flash_bwd_hm_split_cuda, fa._hm_backward_split_ref))
    q, k, v, dout = (rand(b * h, s, d) for _ in range(4))
    out, lse = fa.flash_fwd_hm_cuda(q, k, v, True)
    dq, dk, dv = bwd(q, k, v, out, lse, dout, True)
    again = bwd(q, k, v, out, lse, dout, True)
    step = 16 if s <= 8192 else 1
    lse_of = lambda sl: lse[sl].unsqueeze(1)
    refs_of = lambda sl: bwd_ref(q[sl], k[sl], v[sl], out[sl], lse[sl],
                                 dout[sl], True)
    heads = 1
else:
    if kvh == h:
        qkv = rand(b, s, 3 * h * d)
        q, k, v = cs._packed(qkv)
        grads = [torch.zeros_like(qkv) for _ in range(2)]
        dq, dk, dv = cs._packed(grads[0])
        again = cs._packed(grads[1])
    else:
        q = rand(b, s, h * d)
        k, v = (rand(b, s, kvh * d) for _ in range(2))
        dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
        again = [torch.zeros_like(x) for x in (q, k, v)]
    dout = rand(b, s, h * d)
    out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
    fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, True, dq, dk, dv)
    fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, True, *again)
    step = 1
    lse_of = lambda sl: lse[sl]
    refs_of = lambda sl: fa._nl_backward_ref(q[sl], k[sl], v[sl], out[sl],
                                             lse[sl], dout[sl], h, True)
    heads = h
torch.cuda.synchronize()
res = {n: {"pass": True, "worst_err_over_tol": 0.0}
       for n in ("dq", "dk", "dv")}
res["same_bytes"] = all(torch.equal(x, y)
                        for x, y in zip((dq, dk, dv), again))
for i in range(0, q.shape[0], step):
    sl = slice(i, i + step)
    refs = refs_of(sl)
    terms = cs._attention_terms(q[sl], k[sl], v[sl], out[sl], lse_of(sl),
                                dout[sl], heads, True)[1:]
    for name, got, ref, t in zip(("dq", "dk", "dv"), (dq[sl], dk[sl], dv[sl]),
                                 refs, terms):
        r = res[name]
        try:
            cs._check_close(got, ref, name, t)
        except Failed:
            r["pass"] = False
        ratio = (got.float() - ref.float()).abs() / cs._close_tol(ref, t)
        r["worst_err_over_tol"] = max(r["worst_err_over_tol"],
                                      float(ratio.max()))
print(json.dumps(res))
"""


# Run as _CHECK is, with the repository root as argv[1]: chip_smoke's
# [custom_op] cases of K9 against its plain version (each output filled
# with NaN before K9 writes it), how the kernel splits each case (scalar
# head, 16-byte vectors, scalar tail: a non-contiguous x is copied to a
# fresh, aligned tensor first), and whether two calls give equal bytes.
_SCALE_CHECK = r"""
import json, os, sys
import torch
sys.path.insert(1, sys.argv[1])
import chip_smoke as cs
from paddle_tpu_torch.testing import custom_scale
assert custom_scale.__file__.startswith(os.getcwd()), custom_scale.__file__
g = torch.Generator(device="cuda").manual_seed(5)
res = {"mismatches": {}, "split": {}}
for name, x, f in cs.scale_cases(g):
    res["mismatches"][name] = cs.scale_mismatches(x, f)[0]
    off = x.data_ptr() % 16 if x.is_contiguous() else 0
    res["split"][name] = custom_scale.scale_split(x.numel(), off,
                                                  x.element_size())
x = torch.randn(*cs.SCALE_SHAPE, generator=g, device="cuda").bfloat16()
a, b = (custom_scale.scale_cuda(x, 0.1) for _ in range(2))
res["same_bytes"] = torch.equal(cs._bits(a), cs._bits(b))
print(json.dumps(res))
"""

# Run as _CHECK is: chip_smoke's K3 check (ln_bwd_check: dx, dw and db per
# element, outputs NaN-filled first) at every case of LN_BWD_CASES in bf16
# and fp32, each output failing if any case fails it, the worst |kernel -
# plain| / tolerance of each, and whether two calls at the GPT step's
# shape give equal bytes.
_LN_CHECK = r"""
import json, os, sys
import torch
sys.path.insert(1, sys.argv[1])
import chip_smoke as cs
from paddle_tpu_torch.nn.functional import norm
assert norm.__file__.startswith(os.getcwd()), norm.__file__
g = torch.Generator(device="cuda").manual_seed(3)
res = {n: {"pass": True, "worst_err_over_tol": 0.0}
       for n in ("dx", "dw", "db")}
for dt in (torch.bfloat16, torch.float32):
    for r, d, with_w in cs.LN_BWD_CASES:
        x, w, gy = cs.ln_bwd_inputs(r, d, with_w, dt, g)
        for name, (err, ok, worst) in cs.ln_bwd_check(x, w, gy).items():
            if name == "dx":
                worst = abs(worst["got"] - worst["ref"]) / worst["tol"]
                worst = worst if worst == worst else float("inf")  # NaN
            res[name]["pass"] &= ok
            res[name]["worst_err_over_tol"] = max(
                res[name]["worst_err_over_tol"], worst)
res["same_bytes"] = cs.ln_bwd_same_bytes(*cs.ln_bwd_inputs(
    cs.TRAIN_B * cs.TRAIN_S, 2048, True, torch.bfloat16, g))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def copies(tmp_path_factory, request):
    """{copy name: directory holding its paddle_tpu_torch}, every copy's
    kernels built: the committed tree first, then each edited copy that a
    selected test runs, which keeps the committed K4/K6 library and
    builds only its edited source (one process per copy, all started
    together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    from paddle_tpu_torch import csrc

    build = "from paddle_tpu_torch import csrc; csrc.build_all()"
    run = subprocess.run([sys.executable, "-c", build], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, f"build failed:\n{run.stdout[-3000:]}"
    root = tmp_path_factory.mktemp("bwd_copies")
    dirs = {COMMITTED: REPO}
    missing = []
    selected = set()
    for item in request.session.items:
        params = getattr(getattr(item, "callspec", None), "params", {})
        if "run_id" in params:
            selected.add(RUNS[params["run_id"]][0])
        selected.add(params.get("copy"))
    for name, (old, new, _, _, kernel) in MUTANTS.items():
        if name not in selected:
            continue
        d = root / name
        src = d / SOURCES[kernel]
        shutil.copytree(REPO / "paddle_tpu_torch", d / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        kept = [cu for cu in KEPT if cu != src.name]
        for cu in src.parent.glob("*.cu"):
            if cu.name not in kept + [src.name]:
                cu.unlink()
        text = src.read_text()
        if text.count(old) != 1:
            missing.append(name)
            continue
        src.write_text(text.replace(old, new))
        lib_dir = d / "build" / "paddle_tpu_torch"
        lib_dir.mkdir(parents=True)
        for cu in kept:
            lib = csrc.library_path(REPO / CSRC / cu)
            shutil.copy2(lib, lib_dir / lib.name)
        dirs[name] = d
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items() if n != COMMITTED}
    for n, p in procs.items():
        log, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"build of {n} failed:\n{log[-3000:]}"
    return dirs, missing


def _run(copies, copy, kernel, shape):
    dirs, missing = copies
    assert copy not in missing, \
        f"{copy}: the edited text is not in {SOURCES[kernel]} exactly once"
    run = subprocess.run(
        [sys.executable, "-c", _CHECK, str(REPO), kernel,
         *(str(x) for x in SHAPES[shape])],
        cwd=dirs[copy], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def _check_run(copies, run_id):
    copy, kernel, shape = RUNS[run_id]
    res = _run(copies, copy, kernel, shape)
    print(f"{run_id} ({kernel}, {shape}): " + json.dumps(res))
    failed = {n for n in ("out", "lse", "dq", "dk", "dv")
              if n in res and not res[n]["pass"]}
    want = set() if copy == COMMITTED else MUTANTS[copy][2]
    assert failed == want, res


@pytest.mark.card
@pytest.mark.parametrize("run_id", [r for r in RUNS if RUNS[r][1] == "k4"])
def test_k4_check_rejects_broken_kernels(copies, run_id):
    _check_run(copies, run_id)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["gpt", "tinyllama"])
def test_k4_gives_the_same_bytes_twice(copies, shape):
    """Two forward calls on the same inputs write equal out and lse:
    each element has one writer (its q tile's CTA, one warpgroup)."""
    res = _run(copies, COMMITTED, "k4", shape)
    assert res["same_bytes"], res


@pytest.mark.card
@pytest.mark.parametrize("run_id", [r for r in RUNS if RUNS[r][1] == "k5"])
def test_k5_check_rejects_broken_kernels(copies, run_id):
    _check_run(copies, run_id)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["gpt", "tinyllama"])
def test_k5_gives_the_same_bytes_twice(copies, shape):
    """Two backward calls on the same inputs write equal dq, dk and dv:
    every output element has one writer that sums in a fixed order."""
    res = _run(copies, COMMITTED, "k5", shape)
    assert res["same_bytes"], res


@pytest.mark.card
@pytest.mark.parametrize("run_id", [r for r in RUNS if RUNS[r][1] == "k7"])
def test_k7_check_rejects_broken_kernels(copies, run_id):
    _check_run(copies, run_id)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["gpt", "tinyllama_ramp"])
def test_k7_gives_the_same_bytes_twice(copies, shape):
    """Two K7 calls on the same inputs write equal dq, dk and dv: each
    (kv tile, head) CTA owns its dk and dv, and dq's partials are added
    into the scratch in ascending kv-tile order, one CTA after another
    through the per-(head, q tile) counters."""
    res = _run(copies, COMMITTED, "k7", shape)
    assert res["same_bytes"], res


@pytest.mark.card
@pytest.mark.parametrize("run_id", [r for r in RUNS if RUNS[r][1] == "k8"])
def test_k8_check_rejects_broken_kernels(copies, run_id):
    _check_run(copies, run_id)


@pytest.mark.card
@pytest.mark.parametrize("shape", ["gpt", "long"])
def test_k8_gives_the_same_bytes_twice(copies, shape):
    """Two K8 calls on the same inputs write equal dq, dk and dv: each
    element has one writer (its q tile's dq CTA, its kv tile's kv CTA)
    that sums in a fixed order, without atomics."""
    res = _run(copies, COMMITTED, "k8", shape)
    assert res["same_bytes"], res


def _run_script(copies, copy, kernel, script):
    dirs, missing = copies
    assert copy not in missing, \
        f"{copy}: the edited text is not in {SOURCES[kernel]} exactly once"
    run = subprocess.run([sys.executable, "-c", script, str(REPO)],
                         cwd=dirs[copy], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"{copy} ({kernel}): " + json.dumps(res))
    return res


@pytest.mark.card
@pytest.mark.parametrize("copy", [COMMITTED, "k9_tail_dropped"])
def test_k9_check_rejects_a_kernel_without_its_tail(copies, copy):
    """The committed K9 equals its plain version bit for bit at every
    case of chip_smoke's [custom_op] phase (fp32 and bf16, factors 2,
    0.1, 1/3; [4, 2048, 2048], [2, 4], n = 1, n = 4097, a view offset by
    one element, a transposed view, empty; the FFN's [8192, 8192] bf16 at
    0.5) and gives equal bytes twice; a copy that drops the scalar tail
    fails exactly the cases whose length leaves a tail, n = 4097 among
    them."""
    res = _run_script(copies, copy, "k9", _SCALE_CHECK)
    failed = {n for n, bad in res["mismatches"].items() if bad}
    if copy == COMMITTED:
        assert not failed and res["same_bytes"], res
        return
    want = {n for n, (_, _, tail) in res["split"].items() if tail}
    assert {n for n in want if n.startswith("n=4097")}, res
    assert failed == want, res


@pytest.mark.card
@pytest.mark.parametrize("copy", ["k9_last_vector_in_flight_not_stored"])
def test_k9_check_rejects_a_kernel_that_drops_its_last_vector_in_flight(
        copies, copy):
    """A copy of K9 that never stores a thread's last vector in flight
    fails exactly the [custom_op] cases with more than (kVecsInFlight -
    1) * kThreads vectors, which are some of the cases and not all."""
    from paddle_tpu_torch.testing import custom_scale as sc

    res = _run_script(copies, copy, "k9", _SCALE_CHECK)
    failed = {n for n, bad in res["mismatches"].items() if bad}
    last = (sc.SCALE_VECS_IN_FLIGHT - 1) * sc.SCALE_THREADS
    want = {n for n, (_, nvec, _) in res["split"].items() if nvec > last}
    assert want and want != set(res["split"]), res
    assert failed == want, res


@pytest.mark.card
@pytest.mark.parametrize("copy", [COMMITTED] + [
    n for n in MUTANTS if MUTANTS[n][4] == "k3"])
def test_k3_check_rejects_broken_kernels(copies, copy):
    """The committed K3 passes chip_smoke's per-element check of dx, dw
    and db at every case of LN_BWD_CASES in bf16 and fp32 ([8192, 2048],
    ragged rows with and without a weight on the cp.async-ring kernel,
    d = 6144 and d = 1001 on the shared-memory one); each edited copy
    fails it in exactly the outputs its edit breaks."""
    res = _run_script(copies, copy, "k3", _LN_CHECK)
    failed = {n for n in ("dx", "dw", "db") if not res[n]["pass"]}
    want = set() if copy == COMMITTED else MUTANTS[copy][2]
    assert failed == want, res


@pytest.mark.card
def test_k3_gives_the_same_bytes_twice(copies):
    """Two K3 calls on the same inputs at [8192, 2048] bf16 write equal
    dx, dw and db: every output has one writer, the partials are summed
    in a fixed order, and no float atomics are used."""
    res = _run_script(copies, COMMITTED, "k3", _LN_CHECK)
    assert res["same_bytes"], res


# ---------------------------------------------------------------------------
# the continuous-batching session's decode graph on the card
# ---------------------------------------------------------------------------

def _cb_pair(family):
    """(CPU model, card model) of the tiny config with the same fp32
    weights, in eval mode."""
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)

    if family == "gpt":
        cls, cfg = GPTForCausalLM, gpt_tiny()
    else:
        cls, cfg = LlamaForCausalLM, llama_tiny(num_kv_heads=2)
    cpu = cls(cfg, device="cpu", generator=seed(7, "cpu"))
    card = cls(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu.eval(), card.eval()


def _cb_requests():
    import numpy as np

    rs = np.random.RandomState(5)
    shared = rs.randint(1, 1000, 16)
    tails = [rs.randint(1, 1000, n) for n in (3, 9, 0, 14, 5)]
    return [(i, np.concatenate([shared, t]), 12) for i, t in enumerate(tails)]


def _cb_serve(model, **kw):
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    sess = ContinuousBatchingSession(model, slots=2, max_prompt_len=32,
                                     kv_block_size=8, chunk=4, **kw)
    for rid, p, n in _cb_requests():
        sess.submit(Request(rid, p, n))
    out = sess.run()
    sess._pool.assert_quiescent()
    return out, sess


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cb_card_greedy_streams_equal_cpu(family):
    """The decode chunk as a CUDA graph serves, in fp32 with TF32 off,
    the CPU session's greedy streams (prefix hits, a full hit with CoW)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _cb_pair(family)
    want, csess = _cb_serve(cpu)
    got, sess = _cb_serve(card)
    assert sess._chunk_prog.graph is not None
    assert sess.stats == csess.stats and sess.stats["prefix_cow"] >= 1
    for rid in want:
        assert list(got[rid]) == list(want[rid]), rid


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cb_card_sampled_graph_equals_eager(family):
    """A sampled session's decode graph draws from the session's own
    generator (registered with the graph): a chunk replayed from the
    graph gives the tokens the same chunk gives eagerly from the same
    state and generator state, and the sampled streams are the same
    with the prefix cache on and off and on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    _, card = _cb_pair(family)
    kw = dict(do_sample=True, temperature=0.9, top_k=30)
    on, _ = _cb_serve(card, **kw)
    again, _ = _cb_serve(card, **kw)
    off, _ = _cb_serve(card, prefix_cache=False, **kw)
    for rid in on:
        assert list(on[rid]) == list(again[rid]) == list(off[rid]), rid

    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    sess = ContinuousBatchingSession(card, slots=2, max_prompt_len=32,
                                     kv_block_size=8, chunk=4, **kw)
    for rid, p, n in _cb_requests()[:2]:
        sess.submit(Request(rid, p, n))
    sess.step()                                   # the admit
    live = [s.req is not None for s in sess._slots]
    sess._live_dev.copy_(torch.tensor(live))
    sess._bt_dev.copy_(torch.from_numpy(sess._bt))
    state = [t.clone() for t in sess._kcs + sess._vcs
             + (sess._seq_lens, sess._tok_dev)]
    gen = sess._gen.get_state()
    sess._chunk_body()
    eager = sess._toks_dev.clone()
    for t, c in zip(sess._kcs + sess._vcs + (sess._seq_lens, sess._tok_dev),
                    state):
        t.copy_(c)
    sess._gen.set_state(gen)
    sess._chunk_prog()
    torch.cuda.synchronize()
    assert torch.equal(sess._toks_dev, eager)
    # the replay advanced the generator (the next chunk draws anew)
    assert not torch.equal(sess._gen.get_state(), gen)


@pytest.mark.card
def test_cb_capture_survives_dead_sessions():
    """Sessions are reference cycles, so a dead one (and its CUDA graph)
    waits for the garbage collector. Building a session while dead ones
    are about and the collector runs at every allocation still captures
    its decode graph: no collection may free a graph mid-capture."""
    import gc

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    _, card = _cb_pair("gpt")
    want = [_cb_serve(card)[0] for _ in range(2)]      # two dead sessions
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got, sess = _cb_serve(card)
    finally:
        gc.set_threshold(*old)
    assert sess._chunk_prog.graph is not None
    for rid in got:
        assert list(got[rid]) == list(want[0][rid]) == list(want[1][rid])


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_cb_card_weight_rebound_mid_decode_equals_cpu(family):
    """Every weight replaced by a new tensor (``param.data = ...``)
    between two decode chunks, with nothing queued, and the freed
    memory refilled with NaN: the card session re-captures its decode
    graph before the next replay and serves the CPU session's streams
    under the same replacement, which differ from the unreplaced ones.
    Under both engines: with the overlapped one the chunk before the
    swap is still in flight (its replay reads the old weights, which the
    allocator hands to the NaN fill only after it on the stream), and
    the re-capture waits for its harvest."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = _cb_requests()[:2]            # two slots: nothing stays queued

    def serve(model, overlap):
        sess = ContinuousBatchingSession(model, slots=2, max_prompt_len=32,
                                         kv_block_size=8, chunk=4,
                                         overlap=overlap)
        for rid, p, n in reqs:
            sess.submit(Request(rid, p, n))
        assert sess.step() and sess.step()        # the admit, one chunk
        assert not sess._queue
        assert (sess._ov.inflight is not None) == overlap  # in flight
        before = sess._chunk_prog
        with torch.no_grad():
            for prm in model.parameters():
                prm.data = prm.detach().flip(0).clone()
        junk = [torch.full_like(prm, float("nan"))
                for prm in model.parameters()]
        out = sess.run()
        sess._pool.assert_quiescent()
        del junk
        return out, before, sess

    for overlap in (False, True):
        cpu, card = _cb_pair(family)
        plain, _ = _cb_serve(cpu)
        want, _, _ = serve(cpu, overlap)
        got, before, sess = serve(card, overlap)
        assert sess._chunk_prog is not before
        assert sess._chunk_prog.graph is not None
        for rid in want:
            assert list(got[rid]) == list(want[rid]), (overlap, rid)
        assert any(list(want[rid]) != list(plain[rid]) for rid in want)


@pytest.mark.card
def test_cb_card_sampled_capture_rate():
    """40 sampled sessions built in a row (both families, dead sessions
    left to the garbage collector between them) all capture their
    decode graph, and each serves two requests on the overlapped engine
    (the admit widths they use captured mid-serving, never with a replay
    in flight). A sampled capture once failed on the card with
    cudaErrorStreamCaptureInvalidated, cause not found; this prints
    the failure count of the loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    models = [_cb_pair(f)[1] for f in ("gpt", "llama")]
    failures = []
    for i in range(40):
        try:
            sess = ContinuousBatchingSession(
                models[i % 2], slots=2, max_prompt_len=32, kv_block_size=8,
                chunk=4, do_sample=True, temperature=0.9, top_k=30)
            assert sess._chunk_prog.graph is not None and sess._overlap
            for rid, p, n in _cb_requests()[i % 3:i % 3 + 2]:
                sess.submit(Request(rid, p, 6, seed=i))
            sess.run()
            assert sess._ov.overlapped > 0
        except Exception as e:            # counted, then reported
            failures.append((i, repr(e)))
    print(f"sampled captures: {len(failures)} of 40 failed {failures}")
    assert not failures, failures


@pytest.mark.card
@pytest.mark.parametrize("spec", [False, True], ids=["decode", "ngram"])
def test_cb_card_engines_sampled_byte_equal(spec):
    """Pinned-seed sampled streams of the overlapped and the sequential
    engine are byte-equal on the card (decode chunks, and n-gram verify
    windows with device accept), and so are greedy n-gram streams over
    periodic prompts; the overlapped engine launches staged programs
    (sampled chunks; greedy windows, and sampled windows at temperature
    0.1, whose samples follow the period so that windows fully accept
    and stage; at 0.5 they leave it and nothing stages)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decode graph has no CPU mode")
    import numpy as np

    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)
    from paddle_tpu_torch.inference.speculative import SpeculativeConfig

    _, card = _cb_pair("gpt")
    rs = np.random.RandomState(3)
    prompts = [np.tile(rs.randint(1, 1000, n), 4)[:24] for n in (5, 7, 4, 6)]
    sampled = dict(do_sample=True, temperature=0.5, top_k=30)
    cool = dict(do_sample=True, temperature=0.1)
    for samp in ([sampled, cool, {}] if spec else [sampled]):
        out, sessions = {}, {}
        for overlap in (False, True):
            sess = ContinuousBatchingSession(
                card, slots=2, max_prompt_len=32, kv_block_size=8, chunk=4,
                overlap=overlap, **samp,
                speculative=SpeculativeConfig(num_draft_tokens=3, seed=5)
                if spec else None)
            for i, p in enumerate(prompts):
                sess.submit(Request(i, p, 16, seed=i))
            out[overlap], sessions[overlap] = sess.run(), sess
        for rid in out[False]:
            assert list(out[True][rid]) == list(out[False][rid]), (samp, rid)
        assert sessions[True].stats == sessions[False].stats
        if not (spec and samp is sampled):
            assert sessions[True]._ov.overlapped > 0, samp


@pytest.mark.card
@pytest.mark.parametrize("chunk", [1, 4])
def test_cb_card_logprobs_equal_device_sampler(chunk):
    """logprobs=True on the card (raw-logits admit graphs, the device
    sampler's selection run eagerly after each replay from the session's
    registered generator) streams the device-sampled session's bytes
    under pinned seeds at chunk 1 and 4, both families, with a finite
    log p <= 0 per token."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the admit graphs have no CPU mode")
    import numpy as np

    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    for family in ("gpt", "llama"):
        _, card = _cb_pair(family)
        out, reqs = {}, {}
        for logprobs in (False, True):
            sess = ContinuousBatchingSession(
                card, slots=2, max_prompt_len=32, kv_block_size=8,
                chunk=chunk, do_sample=True, temperature=0.8, top_k=40,
                logprobs=logprobs)
            reqs[logprobs] = [Request(rid, p, n, seed=rid)
                              for rid, p, n in _cb_requests()]
            for r in reqs[logprobs]:
                sess.submit(r)
            out[logprobs] = sess.run()
            assert (sess._chunk_prog is None) == logprobs
        for rid in out[False]:
            assert list(out[True][rid]) == list(out[False][rid]), \
                (family, rid)
        for r in reqs[True]:
            lps = np.asarray(r.token_logprobs)
            assert len(lps) == len(r.tokens) and np.isfinite(lps).all()
            assert (lps <= 0).all()


# ---------------------------------------------------------------------------
# the training recipe's options on the card (port slice 8)
# ---------------------------------------------------------------------------

def _chip_smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _recipe_model(family, recompute, layers=2):
    """GPT-3 1.3B's or TinyLlama-1.1B's width at ``layers`` layers on the
    card, weights from seed 1234 (the same with and without recompute)."""
    from dataclasses import replace

    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt3_1p3b)

    if family == "gpt":
        cfg = replace(gpt3_1p3b(), num_layers=layers, recompute=recompute)
        return GPTForCausalLM(cfg, device="cuda",
                              generator=seed(1234, "cuda"))
    cfg = replace(_chip_smoke().tinyllama_1p1b(), num_layers=layers,
                  recompute=recompute)
    return LlamaForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))


def _recipe_batch(model, b=2, s=1024):
    g = torch.Generator(device="cuda").manual_seed(5)
    ids = torch.randint(0, model.cfg.vocab_size, (b, s + 1), device="cuda",
                        generator=g)
    return ids[:, :-1], ids[:, 1:]


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "tinyllama"])
def test_recipe_card_recompute_gives_the_same_gradient_bytes(family):
    """A 2-layer bf16 model at GPT-3 1.3B's / TinyLlama-1.1B's width
    under amp O2 (B=2, S=1024): with recompute, K4 runs twice a layer
    (forward and recompute) and the loss and every gradient equal the run
    without it byte for byte (K4 and K5 are deterministic, and so is the
    embedding's backward: ``F.embedding``'s sorted sum, where
    ``index_select``'s atomic adds once gave wte another last bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    runs = []
    for rc in (False, True):
        model = ptt.amp.decorate(_recipe_model(family, rc), level="O2")
        x, y = _recipe_batch(model)
        fa.FLASH_FWD_KERNEL.reset_counts()
        with ptt.amp.auto_cast(level="O2"):
            _, loss = model(x, labels=y)
        loss.backward()
        torch.cuda.synchronize()
        assert fa.FLASH_FWD_KERNEL.launches == (4 if rc else 2)
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     model.named_parameters()}))
        del model
    (la, ga), (lb, gb) = runs
    assert torch.equal(la, lb), (float(la), float(lb))
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


@pytest.mark.card
def test_recipe_card_stochastic_rounding_is_unbiased():
    """Stochastic rounding on the card: 2^22 copies of 1 + 2^-10 (1/8 of
    a bf16 ulp above 1.0) round to 1.0 or 1 + 2^-7, with a mean within 5
    standard errors (2^-7 sqrt(p (1 - p) / n), p = 1/8) of the value;
    representable values do not move; a generator in the same state gives
    the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.optimizer.optimizer import stochastic_round_bf16

    n, p = 1 << 22, 1 / 8
    x = torch.full((n,), 1.0 + 2.0 ** -10, device="cuda")
    r = stochastic_round_bf16(x, torch.Generator("cuda").manual_seed(3))
    assert set(r.float().unique().tolist()) == {1.0, 1.0078125}
    err = float(r.double().mean()) - (1.0 + 2.0 ** -10)
    bound = 5 * 2.0 ** -7 * (p * (1 - p) / n) ** 0.5
    print(f"stochastic rounding on the card: mean error {err:.3e}, bound "
          f"{bound:.3e}")
    assert abs(err) < bound
    again = stochastic_round_bf16(x, torch.Generator("cuda").manual_seed(3))
    assert torch.equal(r.view(torch.int16), again.view(torch.int16))
    y = torch.tensor([0.5, -2.0, 0.0, 3.140625, float("inf")],
                     device="cuda")
    assert torch.equal(stochastic_round_bf16(
        y, torch.Generator("cuda").manual_seed(4)).float(), y)


@pytest.mark.card
def test_recipe_card_dropout_keep_rate():
    """Dropout on the card keeps 1 - p of 2^24 elements within 5 binomial
    standard deviations, at 1 / (1 - p); the same seed gives the same
    bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from paddle_tpu_torch.core.generator import rng_tracker
    from paddle_tpu_torch.nn import functional as F

    x = torch.ones(4096, 4096, device="cuda", dtype=torch.bfloat16)
    rng_tracker.manual_seed(8)
    y = F.dropout(x, p=0.1)
    kept, n = int((y != 0).sum()), x.numel()
    sd = (n * 0.9 * 0.1) ** 0.5
    print(f"dropout on the card: kept {kept} of {n} (expected "
          f"{n * 0.9:.0f} +- {sd:.0f})")
    assert abs(kept - n * 0.9) < 5 * sd
    assert set(y.float().unique().tolist()) == {
        0.0, float(torch.tensor(1 / 0.9, dtype=torch.bfloat16))}
    rng_tracker.manual_seed(8)
    assert torch.equal(F.dropout(x, p=0.1), y)


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "tinyllama"])
def test_recipe_card_step_launches_the_expected_kernels(family, monkeypatch):
    """One step of chip_smoke's [train_recipe] plan (recompute, bf16
    moments with stochastic rounding, no masters; GPT with the schedule
    and the clip) at 2 layers: the wrappers count, outside any capture,
    GPT 9 K2, 5 K3, 4 K4 and 2 K5; TinyLlama 9 K1, 4 K4 and 2 K5; no
    plain call; the loss is finite and the state is as planned."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: None if cond else pytest.fail(msg))
    model, opt, sched = cs._recipe(family == "gpt")(
        _recipe_model(family, True))
    x, y = _recipe_batch(model)
    if family == "gpt":
        want = {norm.LAYER_NORM_KERNEL: 9, norm.LAYER_NORM_BWD_KERNEL: 5,
                fa.FLASH_FWD_KERNEL: 4, fa.FLASH_BWD_KERNEL: 2,
                fused_ops.RMS_NORM_KERNEL: 0}
    else:
        want = {fused_ops.RMS_NORM_KERNEL: 9, fa.FLASH_FWD_KERNEL: 4,
                fa.FLASH_BWD_KERNEL: 2, norm.LAYER_NORM_KERNEL: 0,
                norm.LAYER_NORM_BWD_KERNEL: 0}
    for k in want:
        k.reset_counts()
    with ptt.amp.auto_cast(level="O2"):
        _, loss = model(x, labels=y)
    loss.backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    got = {k.symbol: (k.launches, k.plain_calls) for k in want}
    assert got == {k.symbol: (n, 0) for k, n in want.items()}, got
    assert torch.isfinite(loss)
    cs._recipe_state(f"card {family}")(model, opt)


# ---------------------------------------------------------------------------
# default decoding and the admit graphs on the card
# ---------------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("heads", [(16, 16, 128), (32, 4, 64)],
                         ids=["16:16-d128", "32:4-d64"])
@pytest.mark.parametrize("sk", [1, 77, 512, 4096])
def test_k4_card_one_query_row_equals_plain(monkeypatch, dtype, heads, sk):
    """K4 at a dense decode step's shape, one causal query row against Sk
    keys (Sq = Sk = 1 included), B=4: out and lse held per element
    against the plain version (chip_smoke._check_attention_fwd: the
    training cases' tolerances), two calls the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: None if cond else pytest.fail(msg))
    h, kvh, d = heads
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    g = torch.Generator(device="cuda").manual_seed(sk)
    errs = cs._check_attention_fwd(f"sq=1 sk={sk}", 4, 1, sk, h, d, dt, g,
                                   kvh)
    print(f"K4 one row, sk={sk} {h}:{kvh} d={d} {dtype}: {errs}")


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
def test_generate_card_default_paths_equal_cpu(family):
    """The default dense generate, the eager paged loop and (GPT)
    use_cache=False on the card, in fp32 with TF32 off, give the CPU's
    greedy streams at a prompt length off every tile (77, B=2); the dense
    loop launches the fp32 K4 entry once a layer a token (the prefill and
    the one-row steps) and no plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    import numpy as np

    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _cb_pair(family)
    ids = np.random.RandomState(3).randint(1, 1000, (2, 77)).astype(np.int64)
    paths = [{}, dict(use_paged_kv=True, aot=False, kv_block_size=8)]
    if family == "gpt":
        paths.append(dict(use_cache=False))
    for kw in paths:
        fa.FLASH_FWD_FP32_KERNEL.reset_counts()
        got = card.generate(ids, max_new_tokens=6, **kw).cpu().numpy()
        if not kw:
            assert fa.FLASH_FWD_FP32_KERNEL.launches == (
                card.cfg.num_layers * 6)
            assert fa.FLASH_FWD_FP32_KERNEL.plain_calls == 0
        want = cpu.generate(ids, max_new_tokens=6, **kw).numpy()
        assert np.array_equal(got, want), kw


def _cb_admit_session(model, eager=False, **kw):
    """A session whose chunked prefill (5 tokens a chunk) and prefix cache
    run admits at several widths, serving _cb_requests."""
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    cs = _chip_smoke()
    sess = ContinuousBatchingSession(model, slots=2, max_prompt_len=32,
                                     kv_block_size=8, chunk=4,
                                     prefill_chunk=5, **kw)
    checked = {}
    if eager:
        cs.cb_eager_programs(sess)
    elif next(model.parameters()).is_cuda:
        checked = cs.cb_compare_admits(sess, "card test")
    for rid, p, n in _cb_requests():
        sess.submit(Request(rid, p, n))
    out = sess.run()
    sess._pool.assert_quiescent()
    return out, checked, sess


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_cb_card_admit_graphs_equal_eager(monkeypatch, family, sampled):
    """Each admit width's CUDA graph against the same admit run eagerly
    from the same state and generator state (chip_smoke
    cb_compare_admits: equal tokens, lengths and pool bytes), at every
    width the run uses; the whole run's streams equal those of the same
    session with every program eager, byte for byte (sampled too), and,
    greedy in fp32 with TF32 off, the CPU session's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the admit graphs have no CPU mode")
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: None if cond else pytest.fail(msg))
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _cb_pair(family)
    kw = dict(do_sample=True, temperature=0.9, top_k=30) if sampled else {}
    got, checked, sess = _cb_admit_session(card, **kw)
    # width max_prompt_len (32) is captured with the session, used or not
    assert len(checked) >= 2
    assert set(checked) | {32} == set(sess._admit_progs)
    assert all(p.graph is not None for p in sess._admit_progs.values())
    assert sess._captures == 1 + len(sess._admit_progs)
    eager, _, esess = _cb_admit_session(card, eager=True, **kw)
    assert all(p.graph is None for p in esess._admit_progs.values())
    for rid in eager:
        assert list(got[rid]) == list(eager[rid]), rid
    if not sampled:
        want, _, _ = _cb_admit_session(cpu)
        for rid in want:
            assert list(got[rid]) == list(want[rid]), rid


@pytest.mark.card
def test_cb_card_sampled_admit_capture_rate():
    """40 sampled sessions in a row (both families), each serving two
    requests in chunks of 8, capture their decode graph and an admit graph
    at every width they use (test_cb_card_sampled_capture_rate with the
    admits; ROADMAP queue C item 11). Prints the failure count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs have no CPU mode")
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    models = [_cb_pair(f)[1] for f in ("gpt", "llama")]
    failures, widths = [], 0
    for i in range(40):
        try:
            sess = ContinuousBatchingSession(
                models[i % 2], slots=2, max_prompt_len=32, kv_block_size=8,
                chunk=4, prefill_chunk=8, do_sample=True, temperature=0.9,
                top_k=30)
            for rid, p, _ in _cb_requests()[:2]:
                sess.submit(Request(rid, p, 3))
            sess.run()
            assert sess._chunk_prog.graph is not None and sess._admit_progs
            assert all(p.graph is not None
                       for p in sess._admit_progs.values())
            widths += len(sess._admit_progs)
        except Exception as e:            # counted, then reported
            failures.append((i, repr(e)))
    print(f"sampled captures with admits: {len(failures)} of 40 sessions "
          f"failed ({widths} admit graphs captured) {failures}")
    assert not failures, failures


# ---------------------------------------------------------------------------
# speculative decoding's verify graphs on the card (port slice 10)
# ---------------------------------------------------------------------------

def _spec_requests():
    """_cb_requests' prompts with 3-12 new tokens: the requests end at
    different remaining budgets, so the windows take several widths."""
    return [(rid, p, n) for (rid, p, _), n in zip(_cb_requests(),
                                                   (3, 8, 4, 12, 6))]


def _spec_session(model, eager=False, compare=False, **kw):
    """A speculative session (the model as its own draft, k = 4) serving
    _spec_requests; with ``compare`` the first window at each width runs
    graph against eager (chip_smoke cb_compare_verify)."""
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    cs = _chip_smoke()
    sess = ContinuousBatchingSession(
        model, slots=2, max_prompt_len=32, kv_block_size=8,
        speculative={"proposer": "draft", "draft_model": model}, **kw)
    checked = {}
    if eager:
        cs.cb_eager_programs(sess)
    elif compare:
        checked = cs.cb_compare_verify(sess, "card test")
    for rid, p, n in _spec_requests():
        sess.submit(Request(rid, p, n))
    out = sess.run()
    sess._pool.assert_quiescent()
    return out, checked, sess


@pytest.mark.card
@pytest.mark.parametrize("family", ["gpt", "llama"])
@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_cb_card_spec_verify_graphs_equal_eager(monkeypatch, family,
                                                sampled):
    """Each verify width's CUDA graph (forward, acceptance fold and the
    rollback of the lengths) against the same window run eagerly from
    the same state and generator states (chip_smoke cb_compare_verify:
    equal tokens, accepted counts, boundaries, lengths and pool bytes)
    at every width the run uses; the run's streams equal those of the
    same session with every program eager and, greedy in fp32 with TF32
    off, the CPU session's; sampled, host accept
    (PADDLE_SPEC_DEVICE_ACCEPT=0) streams the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the verify graphs have no CPU mode")
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "check",
                        lambda cond, msg: None if cond else pytest.fail(msg))
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu, card = _cb_pair(family)
    kw = dict(do_sample=True, temperature=0.9, top_k=30) if sampled else {}
    got, checked, sess = _spec_session(card, compare=True, **kw)
    progs = sess._verify_ladder.programs
    print(f"{family} {'sampled' if sampled else 'greedy'}: verify widths "
          f"checked graph against eager {sorted(checked)}")
    assert len(checked) >= (3 if sampled else 2), checked
    assert set(checked) == set(progs), (checked, progs)
    assert all(p.graph is not None for p in progs.values())
    assert sess.stats["spec_steps"] > 0 and sess._chunk_prog is None
    eager, _, esess = _spec_session(card, eager=True, **kw)
    assert all(p.graph is None
               for p in esess._verify_ladder.programs.values())
    for rid in eager:
        assert list(got[rid]) == list(eager[rid]), rid
    if sampled:
        monkeypatch.setenv("PADDLE_SPEC_DEVICE_ACCEPT", "0")
        host, _, hsess = _spec_session(card, **kw)
        assert hsess._spec_accept == "host"
        for rid in host:
            assert list(got[rid]) == list(host[rid]), rid
    else:
        want, _, csess = _spec_session(cpu)
        assert csess.stats == sess.stats
        for rid in want:
            assert list(got[rid]) == list(want[rid]), rid


@pytest.mark.card
def test_cb_card_sampled_spec_capture_rate():
    """40 sampled speculative sessions in a row (both families, each its
    own draft), each serving two requests, capture every verify width
    they use, the admit widths and the draft's decode step
    (test_cb_card_sampled_admit_capture_rate with the verify ladder;
    ROADMAP queue C item 11). Prints the failure count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs have no CPU mode")
    from paddle_tpu_torch.inference.serving import (
        ContinuousBatchingSession, Request)

    models = [_cb_pair(f)[1] for f in ("gpt", "llama")]
    failures, widths = [], 0
    for i in range(40):
        try:
            sess = ContinuousBatchingSession(
                models[i % 2], slots=2, max_prompt_len=32, kv_block_size=8,
                speculative={"proposer": "draft", "draft_model":
                             models[i % 2], "seed": i},
                do_sample=True, temperature=0.9, top_k=30)
            for rid, p, _ in _spec_requests()[:2]:
                sess.submit(Request(rid, p, 10))
            sess.run()
            progs = sess._verify_ladder.programs
            assert progs and all(p.graph is not None
                                 for p in progs.values())
            assert all(p.graph is not None
                       for p in sess._admit_progs.values())
            assert sess._proposer._engine._decode_prog.graph is not None
            widths += len(progs)
        except Exception as e:            # counted, then reported
            failures.append((i, repr(e)))
    print(f"sampled spec captures: {len(failures)} of 40 sessions failed "
          f"({widths} verify graphs captured) {failures}")
    assert not failures, failures
