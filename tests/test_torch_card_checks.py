"""Card only: chip_smoke.py's per-element checks of the flash-attention
backwards against their plain versions reject broken kernels, and both
backwards give the same bytes on every call: K5 (native layout,
``csrc/flash_bwd.cu``) and K7 (head-major one-pass,
``csrc/flash_bwd_hm.cu``).

Copies of ``paddle_tpu_torch``, each with one edit to one of those
sources, are built in a temporary directory and run causal, bf16, at
the GPT-3 1.3B training step's shape (B=4, S=2048, H=16, D=128; K5 reads
a packed qkv, K7 head-major [B*H,S,D]) or at TinyLlama-1.1B's (B=8,
S=2048, 32 heads of D=64: K5 over 4 kv heads, K7 on the ramp's k, v
repeated to the 32 heads). The K5 edits: a kv-tile CTA of the dk/dv
kernel that returns at once, every dk/dv CTA skipping its last q tile,
dV skipping the q tile at row 1024, the dq kernel skipping the kv tile
at 1024, and, grouped, dk/dv skipping the last q head of each kv head's
group and the CTAs of kv head 1 returning at once. The K7 edits: the dq
add of the middle kv tile dropped, the last q tile's terms dropped, dk
left unscaled, and the causal start of each kv tile's q tiles one tile
late. Each copy must fail the check in exactly the gradients it breaks,
and the committed kernels must pass it at both shapes; an edit whose
text is not in its source exactly once fails its test. Each test prints
its worst |kernel - plain| / tolerance per gradient. Two backward calls
of a committed kernel on the same inputs must give equal dq, dk and dv
bytes. The tests skip without a card; on a machine with one (the tests'
conftest.py sets up JAX, which these tests do not use):

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
SOURCES = {"k5": CSRC / "flash_bwd.cu", "k7": CSRC / "flash_bwd_hm.cu"}
COMMITTED = "committed"
# name -> (B, S, H, KVH, D); H == KVH runs K5 on the packed [B,S,3E]
# layout; K7 takes KVH == H ([B*H,S,D] q, k, v)
SHAPES = {"gpt": (4, 2048, 16, 16, 128), "tinyllama": (8, 2048, 32, 4, 64),
          "tinyllama_ramp": (8, 2048, 32, 32, 64)}

_DKDV_PREFETCH = "    if (it + 1 < n_it) load_q_tile(it + 1, buf ^ 1);\n"
# name -> (source text, its replacement, the gradients that must fail,
# the shape it runs at, the kernel it edits)
MUTANTS = {
    "kv_tile_dropped": (
        "  const int k0 = static_cast<int>(blockIdx.x) * kTileKV;\n",
        "  const int k0 = static_cast<int>(blockIdx.x) * kTileKV;\n"
        "  if (static_cast<int>(blockIdx.x) == gridDim.x / 2) return;\n",
        {"dk", "dv"}, "gpt", "k5"),
    "last_q_tile_skipped": (
        _DKDV_PREFETCH,
        _DKDV_PREFETCH + "    if (q0 + kTileQ >= sq) continue;\n",
        {"dk", "dv"}, "gpt", "k5"),
    "dv_skips_q_tile_1024": (
        "        mma(dv_acc[n], af, b0);\n"
        "        mma(dv_acc[n + 1], af, b1);\n",
        "        if (q0 != 1024) {\n          mma(dv_acc[n], af, b0);\n"
        "          mma(dv_acc[n + 1], af, b1);\n        }\n",
        {"dv"}, "gpt", "k5"),
    "dq_skips_kv_tile_1024": (
        "    // S = Q K^T and dP = dO V^T\n",
        "    if (k0 == 1024) continue;\n    // S = Q K^T and dP = dO V^T\n",
        {"dq"}, "gpt", "k5"),
    "gqa_last_q_head_skipped": (
        _DKDV_PREFETCH,
        _DKDV_PREFETCH + "    if (it / nq == rep - 1) continue;\n",
        {"dk", "dv"}, "tinyllama", "k5"),
    "gqa_kv_head_cta_returns": (
        "  const int kh = blockIdx.y;  // this CTA's kv head\n",
        "  const int kh = blockIdx.y;  // this CTA's kv head\n"
        "  if (kh == 1) return;\n",
        {"dk", "dv"}, "tinyllama", "k5"),
    "k7_dq_add_of_kv_tile_dropped": (
        "        a.x += dqp[n][2 * rh];\n"
        "        a.y += dqp[n][2 * rh + 1];\n",
        "        if (j != nkv / 2) {\n          a.x += dqp[n][2 * rh];\n"
        "          a.y += dqp[n][2 * rh + 1];\n        }\n",
        {"dq"}, "gpt", "k7"),
    "k7_last_q_tile_skipped": (
        "        const bool ok = kv < sk && qrow < sq && "
        "(!causal || kv <= qrow + off);\n",
        "        const bool ok = kv < sk && qrow < sq && "
        "(!causal || kv <= qrow + off) && i != nq - 1;\n",
        {"dq", "dk", "dv"}, "gpt", "k7"),
    "k7_dk_unscaled": (
        "          st_pair<T>(dk + base + n * 8, dk_acc[n][2 * rh] * scale,\n"
        "                     dk_acc[n][2 * rh + 1] * scale);\n",
        "          st_pair<T>(dk + base + n * 8, dk_acc[n][2 * rh],\n"
        "                     dk_acc[n][2 * rh + 1]);\n",
        {"dk"}, "gpt", "k7"),
    "k7_causal_start_one_tile_late": (
        "    return causal && first > 0 ? first / kTileQ : 0;\n",
        "    return causal && first > 0 ? first / kTileQ + 1 : 0;\n",
        {"dq", "dk", "dv"}, "gpt", "k7"),
}
# test id -> (copy, kernel, shape)
RUNS = {COMMITTED: (COMMITTED, "k5", "gpt"),
        COMMITTED + "_gqa": (COMMITTED, "k5", "tinyllama"),
        COMMITTED + "_k7": (COMMITTED, "k7", "gpt"),
        COMMITTED + "_k7_ramp": (COMMITTED, "k7", "tinyllama_ramp"),
        **{n: (n, m[4], m[3]) for n, m in MUTANTS.items()}}

# Run with the package's copy as the working directory and the repository
# root as argv[1] (for chip_smoke), then the kernel (k5 or k7) and B S H
# KVH D: the forward then the backward twice, chip_smoke's check of dq, dk
# and dv (K5 batch element by batch element, K7 sixteen heads at a time),
# and whether the two backward calls gave the same bytes.
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


if kernel == "k7":
    q, k, v, dout = (rand(b * h, s, d) for _ in range(4))
    out, lse = fa.flash_fwd_hm_cuda(q, k, v, True)
    dq, dk, dv = fa.flash_bwd_hm_cuda(q, k, v, out, lse, dout, True)
    again = fa.flash_bwd_hm_cuda(q, k, v, out, lse, dout, True)
    step = 16
    lse_of = lambda sl: lse[sl].unsqueeze(1)
    refs_of = lambda sl: fa._hm_backward_ref(q[sl], k[sl], v[sl], out[sl],
                                             lse[sl], dout[sl], True)
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


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    """{copy name: directory holding its paddle_tpu_torch}, every copy's
    kernels built: the committed tree first, then each edited copy, which
    keeps the committed K4/K6 library and builds only its edited source
    (one process per copy, all started together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    from paddle_tpu_torch import csrc

    build = "from paddle_tpu_torch import csrc; csrc.build_all()"
    run = subprocess.run([sys.executable, "-c", build], cwd=REPO,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, f"build failed:\n{run.stdout[-3000:]}"
    fwd_lib = csrc.library_path(REPO / CSRC / "flash_fwd.cu")
    root = tmp_path_factory.mktemp("bwd_copies")
    dirs = {COMMITTED: REPO}
    missing = []
    for name, (old, new, _, _, kernel) in MUTANTS.items():
        d = root / name
        src = d / SOURCES[kernel]
        shutil.copytree(REPO / "paddle_tpu_torch", d / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for cu in src.parent.glob("*.cu"):
            if cu.name not in ("flash_fwd.cu", src.name):
                cu.unlink()
        text = src.read_text()
        if text.count(old) != 1:
            missing.append(name)
            continue
        src.write_text(text.replace(old, new))
        lib_dir = d / "build" / "paddle_tpu_torch"
        lib_dir.mkdir(parents=True)
        shutil.copy2(fwd_lib, lib_dir / fwd_lib.name)
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
    failed = {n for n in ("dq", "dk", "dv") if not res[n]["pass"]}
    want = set() if copy == COMMITTED else MUTANTS[copy][2]
    assert failed == want, res


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
    """Two K7 calls on the same inputs write equal dq, dk and dv: one CTA
    owns each head and adds into its dq scratch in kv-tile order, without
    atomics."""
    res = _run(copies, COMMITTED, "k7", shape)
    assert res["same_bytes"], res
