"""Card only: chip_smoke.py's per-element check of the flash-attention
backward (K5) against its plain version rejects broken kernels.

Three copies of ``paddle_tpu_torch``, each with one edit to
``csrc/flash_bwd.cu``, are built in a temporary directory and run at the
GPT-3 1.3B training step's shape (B=4, S=2048, H=16, D=128, causal,
bf16): a kv-tile CTA that returns at once, every CTA skipping its last q
tile, and dV skipping the q tile at row 1024. Each copy must fail the
check in exactly the gradients it breaks, and the committed kernel must
pass it. Each test prints its worst |kernel - plain| / tolerance per
gradient. The tests skip without a card; on a machine with one (the
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
BWD = Path("paddle_tpu_torch") / "csrc" / "flash_bwd.cu"
COMMITTED = "committed"

# name -> (source text, its replacement, the gradients that must fail)
MUTANTS = {
    "kv_tile_dropped": (
        "  const int k0 = (nkv - 1 - static_cast<int>(blockIdx.x)) * "
        "kTileKV;\n",
        "  const int k0 = (nkv - 1 - static_cast<int>(blockIdx.x)) * "
        "kTileKV;\n  if (static_cast<int>(blockIdx.x) == nkv / 2) return;\n",
        {"dq", "dk", "dv"}),
    "last_q_tile_skipped": (
        "    if (q0 + kTileQ < sq) load_q_tile(q0 + kTileQ, buf ^ 1);\n",
        "    if (q0 + kTileQ < sq) load_q_tile(q0 + kTileQ, buf ^ 1);\n"
        "    if (q0 + kTileQ >= sq) continue;\n",
        {"dq", "dk", "dv"}),
    "dv_skips_q_tile_1024": (
        "        mma(dv_acc[n], af, b0);\n"
        "        mma(dv_acc[n + 1], af, b1);\n",
        "        if (q0 != 1024) {\n          mma(dv_acc[n], af, b0);\n"
        "          mma(dv_acc[n + 1], af, b1);\n        }\n",
        {"dv"}),
}

# Run with the package's copy as the working directory and the repository
# root as argv[1] (for chip_smoke): K4 then K5 at the step's shape, and
# chip_smoke's check of dq, dk and dv batch element by batch element.
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
b, s, h, d = 4, 2048, 16, 128
e = h * d
g = torch.Generator(device="cuda").manual_seed(3)
qkv = torch.randn(b, s, 3 * e, generator=g, device="cuda").bfloat16()
q, k, v = cs._packed(qkv)
grads = torch.zeros_like(qkv)
dq, dk, dv = cs._packed(grads)
dout = torch.randn(b, s, e, generator=g, device="cuda").bfloat16()
out, lse = fa.flash_fwd_cuda(q, k, v, h, True)
fa.flash_bwd_cuda(q, k, v, out, lse, dout, h, True, dq, dk, dv)
torch.cuda.synchronize()
res = {n: {"pass": True, "worst_err_over_tol": 0.0}
       for n in ("dq", "dk", "dv")}
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
    for name, (old, new, _) in MUTANTS.items():
        d = root / name
        shutil.copytree(REPO / "paddle_tpu_torch", d / "paddle_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for cu in (d / BWD).parent.glob("*.cu"):
            if cu.name not in ("flash_fwd.cu", "flash_bwd.cu"):
                cu.unlink()
        src = (d / BWD).read_text()
        assert src.count(old) == 1, f"{name}: the edited text is not in {BWD}"
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
    return dirs


@pytest.mark.card
@pytest.mark.parametrize("copy", [COMMITTED, *MUTANTS])
def test_k5_check_rejects_broken_kernels(copies, copy):
    run = subprocess.run([sys.executable, "-c", _CHECK, str(REPO)],
                         cwd=copies[copy], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    res = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"{copy}: " + json.dumps(res))
    failed = {n for n, r in res.items() if not r["pass"]}
    want = set() if copy == COMMITTED else MUTANTS[copy][2]
    assert failed == want, res
