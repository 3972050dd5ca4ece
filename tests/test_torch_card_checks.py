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
vectors. The tests skip without a card; on a machine with one (the
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
