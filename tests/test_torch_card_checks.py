"""Card only: chip_smoke.py's per-element check of the flash-attention
backward (K5) against its plain version rejects broken kernels, and K5
gives the same bytes on every call.

Copies of ``paddle_tpu_torch``, each with one edit to
``csrc/flash_bwd.cu``, are built in a temporary directory and run at the
GPT-3 1.3B training step's shape (B=4, S=2048, H=16, D=128, packed qkv)
or at TinyLlama-1.1B's (B=8, S=2048, 32 heads of D=64 over 4 kv heads),
causal, bf16. The edits: a kv-tile CTA of the dk/dv kernel that returns
at once, every dk/dv CTA skipping its last q tile, dV skipping the q tile
at row 1024, the dq kernel skipping the kv tile at 1024, and, grouped,
dk/dv skipping the last q head of each kv head's group and the CTAs of
kv head 1 returning at once. Each copy must fail the check in exactly the
gradients it breaks, and the committed kernel must pass it at both
shapes; an edit whose text is not in the source fails its test. Each
test prints its worst |kernel - plain| / tolerance per gradient. Two
backward calls of the committed kernel on the same inputs must give
equal dq, dk and dv bytes. The tests skip without a card; on a machine
with one (the tests' conftest.py sets up JAX, which these tests do not
use):

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
BWD = Path("paddle_tpu_torch") / "csrc" / "flash_bwd.cu"
COMMITTED = "committed"
# name -> (B, S, H, KVH, D); H == KVH runs the packed [B,S,3E] layout
SHAPES = {"gpt": (4, 2048, 16, 16, 128), "tinyllama": (8, 2048, 32, 4, 64)}

_DKDV_PREFETCH = "    if (it + 1 < n_it) load_q_tile(it + 1, buf ^ 1);\n"
# name -> (source text, its replacement, the gradients that must fail,
# the shape it runs at)
MUTANTS = {
    "kv_tile_dropped": (
        "  const int k0 = static_cast<int>(blockIdx.x) * kTileKV;\n",
        "  const int k0 = static_cast<int>(blockIdx.x) * kTileKV;\n"
        "  if (static_cast<int>(blockIdx.x) == gridDim.x / 2) return;\n",
        {"dk", "dv"}, "gpt"),
    "last_q_tile_skipped": (
        _DKDV_PREFETCH,
        _DKDV_PREFETCH + "    if (q0 + kTileQ >= sq) continue;\n",
        {"dk", "dv"}, "gpt"),
    "dv_skips_q_tile_1024": (
        "        mma(dv_acc[n], af, b0);\n"
        "        mma(dv_acc[n + 1], af, b1);\n",
        "        if (q0 != 1024) {\n          mma(dv_acc[n], af, b0);\n"
        "          mma(dv_acc[n + 1], af, b1);\n        }\n",
        {"dv"}, "gpt"),
    "dq_skips_kv_tile_1024": (
        "    // S = Q K^T and dP = dO V^T\n",
        "    if (k0 == 1024) continue;\n    // S = Q K^T and dP = dO V^T\n",
        {"dq"}, "gpt"),
    "gqa_last_q_head_skipped": (
        _DKDV_PREFETCH,
        _DKDV_PREFETCH + "    if (it / nq == rep - 1) continue;\n",
        {"dk", "dv"}, "tinyllama"),
    "gqa_kv_head_cta_returns": (
        "  const int kh = blockIdx.y;  // this CTA's kv head\n",
        "  const int kh = blockIdx.y;  // this CTA's kv head\n"
        "  if (kh == 1) return;\n",
        {"dk", "dv"}, "tinyllama"),
}
# test id -> (copy, shape)
RUNS = {COMMITTED: (COMMITTED, "gpt"),
        COMMITTED + "_gqa": (COMMITTED, "tinyllama"),
        **{n: (n, m[3]) for n, m in MUTANTS.items()}}

# Run with the package's copy as the working directory and the repository
# root as argv[1] (for chip_smoke), then B S H KVH D: K4 then K5 twice,
# chip_smoke's check of dq, dk and dv batch element by batch element, and
# whether the two K5 calls gave the same bytes.
_CHECK = r'''
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
b, s, h, kvh, d = (int(a) for a in sys.argv[2:7])
g = torch.Generator(device="cuda").manual_seed(3)
if kvh == h:
    qkv = torch.randn(b, s, 3 * h * d, generator=g, device="cuda").bfloat16()
    q, k, v = cs._packed(qkv)
    grads = [torch.zeros_like(qkv) for _ in range(2)]
    dq, dk, dv = cs._packed(grads[0])
    again = cs._packed(grads[1])
else:
    q = torch.randn(b, s, h * d, generator=g, device="cuda").bfloat16()
    k, v = (torch.randn(b, s, kvh * d, generator=g, device="cuda").bfloat16()
            for _ in range(2))
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    again = [torch.zeros_like(x) for x in (q, k, v)]
dout = torch.randn(b, s, h * d, generator=g, device="cuda").bfloat16()
out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, True, dq, dk, dv)
fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, True, *again)
torch.cuda.synchronize()
res = {n: {"pass": True, "worst_err_over_tol": 0.0}
       for n in ("dq", "dk", "dv")}
res["same_bytes"] = all(torch.equal(x, y)
                        for x, y in zip((dq, dk, dv), again))
for i in range(b):
    sl = slice(i, i + 1)
    args = (q[sl], k[sl], v[sl], out[sl], lse[sl], dout[sl], h, True)
    refs = fa._nl_backward_ref(*args)
    terms = cs._attention_terms(*args)[1:]
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
'''


@pytest.fixture(scope="module")
def copies(tmp_path_factory):
    """{copy name: directory holding its paddle_tpu_torch}, every copy's
    kernels built (one process per copy, all started together)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    root = tmp_path_factory.mktemp("k5_copies")
    dirs = {COMMITTED: REPO}
    missing = []
    for name, (old, new, _, _) in MUTANTS.items():
        d = root / name
        shutil.copytree(REPO / "paddle_tpu_torch", d / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for cu in (d / BWD).parent.glob("*.cu"):
            if cu.name not in ("flash_fwd.cu", "flash_bwd.cu"):
                cu.unlink()
        src = (d / BWD).read_text()
        if src.count(old) != 1:
            missing.append(name)
            continue
        (d / BWD).write_text(src.replace(old, new))
        dirs[name] = d
    build = "from paddle_tpu_torch import csrc; csrc.build_all()"
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    for n, p in procs.items():
        log, _ = p.communicate(timeout=900)
        assert p.returncode == 0, f"build of {n} failed:\n{log[-3000:]}"
    return dirs, missing


def _run(copies, copy, shape):
    dirs, missing = copies
    assert copy not in missing, \
        f"{copy}: the edited text is not in {BWD} exactly once"
    run = subprocess.run(
        [sys.executable, "-c", _CHECK, str(REPO),
         *(str(x) for x in SHAPES[shape])],
        cwd=dirs[copy], capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("run_id", list(RUNS))
def test_k5_check_rejects_broken_kernels(copies, run_id):
    copy, shape = RUNS[run_id]
    res = _run(copies, copy, shape)
    print(f"{run_id} ({shape}): " + json.dumps(res))
    failed = {n for n in ("dq", "dk", "dv") if not res[n]["pass"]}
    want = set() if copy == COMMITTED else MUTANTS[copy][2]
    assert failed == want, res


@pytest.mark.card
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k5_gives_the_same_bytes_twice(copies, shape):
    """Two backward calls on the same inputs write equal dq, dk and dv:
    every output element has one writer that sums in a fixed order."""
    res = _run(copies, COMMITTED, shape)
    assert res["same_bytes"], res
