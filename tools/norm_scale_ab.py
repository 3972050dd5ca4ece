#!/usr/bin/env python3
"""Time the LayerNorm backward (K3) and the custom-op scale (K9) of two
checkouts, and variants of this checkout's two kernels, on one card.

    python3 tools/norm_scale_ab.py PARENT_ROOT [all | VARIANT ...] [--mix]

PARENT_ROOT is another checkout of the repository (for example `git
archive <commit>` unpacked under `build/`). Each tree runs in a process of
its own that builds its own `layer_norm_bwd.cu` and `scale.cu` (a copy of
its `paddle_tpu_torch` under `build/norm_scale_ab/`, holding no other CUDA
source) and prints one line `AB <tag> {...}`: card ms (chip_smoke's
`device_ms`: CUDA events over calls in a CUDA graph) of K3 at GPT-3 1.3B's
training shape [8192, 2048] bf16 beside `native_layer_norm_backward`, and
of K9 at fp32 [4, 2048, 2048] x2, bf16 [4, 2048, 2048] x2 and the FFN's
bf16 [8192, 8192] x0.5 beside `torch.mul`; and whether the tree's K3
passes chip_smoke's per-element check at every case of `LN_BWD_CASES` and
gives equal bytes twice, and its K9 equals the plain version bit for bit
at every case of `scale_cases`. The order is parent, change, each named
VARIANT (`all`: every one of `VARIANTS`), change, parent.

A variant is this checkout with a few text edits (`VARIANTS`: file, old
text, new text); each old text must occur exactly once. `--mix` then runs
chip_smoke's `[train]` (GPT-3 1.3B, B=4, S=2048, 5 bf16 O2 AdamW steps)
in this checkout twice, with `ptt_layer_norm_bwd` from this checkout's
library and from the parent's (the entry keeps its signature), and
prints `MIX <K3> {...}` with the losses, to see whether K3 moves the loss
trajectory. It needs a card and nvcc.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "norm_scale_ab"
CSRC = Path("paddle_tpu_torch") / "csrc"
KEEP = ("layer_norm_bwd.cu", "scale.cu")
NORM = Path("paddle_tpu_torch") / "nn" / "functional" / "norm.py"
_GRID = "  if (blocks > kMaxCtas) blocks = kMaxCtas;\n"

_STAGES = "constexpr int kStages = 4;"
_VPT = "constexpr int kVecsPerThread = 2;"
_PARTS = "LN_BWD_CTAS_PER_SM = 2"
_PASS2 = ("  ln_bwd_reduce_kernel<T><<<rgrid, dim3(kRedCols, kRedSplit), 0, "
          "stream>>>(")


def _k3(ctas, stages, vpt=1, pass2=True):
    """Edits for K3 at ``ctas`` CTAs an SM, ``stages`` ring stages and
    ``vpt`` vectors a thread; without pass 2 (its launch skipped: a timing
    of pass 1 alone, whose dw / db are wrong)."""
    edits = [(CSRC / "layer_norm_bwd.cu", _STAGES,
              f"constexpr int kStages = {stages};"),
             (CSRC / "layer_norm_bwd.cu", _VPT,
              f"constexpr int kVecsPerThread = {vpt};"),
             (NORM, _PARTS, f"LN_BWD_CTAS_PER_SM = {ctas}")]
    if not pass2:
        edits.append((CSRC / "layer_norm_bwd.cu", _PASS2,
                      "  if (false) ln_bwd_reduce_kernel<T><<<rgrid, "
                      "dim3(kRedCols, kRedSplit), 0, stream>>>("))
    return edits


# name -> [(file, old text, new text), ...]
VARIANTS = {
    "k9 1 vector in flight": [(
        CSRC / "scale.cu", "constexpr int kVecsInFlight = 2;",
        "constexpr int kVecsInFlight = 1;")],
    "k9 4 vectors in flight": [(
        CSRC / "scale.cu", "constexpr int kVecsInFlight = 2;",
        "constexpr int kVecsInFlight = 4;")],
    "k9 8 vectors in flight": [(
        CSRC / "scale.cu", "constexpr int kVecsInFlight = 2;",
        "constexpr int kVecsInFlight = 8;")],
    "k9 persistent grid, 8 CTAs an SM": [(
        CSRC / "scale.cu", _GRID,
        "  {\n    int dv = 0, sms = 0;\n    cudaGetDevice(&dv);\n"
        "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, "
        "dv);\n    if (blocks > 8LL * sms) blocks = 8LL * sms;\n  }\n")],
    "k9 plain loads and stores": [
        (CSRC / "scale.cu",
         "      if (full || i < nvec) __stcs(yv + i, raw[u]);",
         "      if (full || i < nvec) yv[i] = raw[u];"),
        (CSRC / "scale.cu", "__ldcs(xv + i)", "xv[i]")],
    "k9 128 threads": [(
        CSRC / "scale.cu", "constexpr int kThreads = 256;",
        "constexpr int kThreads = 128;")],
    "k9 512 threads": [(
        CSRC / "scale.cu", "constexpr int kThreads = 256;",
        "constexpr int kThreads = 512;")],
    **{f"k3 {c} CTAs an SM, {s} stages, {v} vectors a thread": _k3(c, s, v)
       for c, s, v in ((3, 2, 1), (2, 4, 1), (3, 3, 1), (2, 3, 2),
                       (3, 3, 2))},
    "k3 pass 1 alone": _k3(2, 4, 2, pass2=False),
    "k3 pass 2 with 8 threads a column": [(
        CSRC / "layer_norm_bwd.cu", "constexpr int kRedSplit = 16;",
        "constexpr int kRedSplit = 8;")],
}

_TIMES = r"""
import json, sys
root = sys.argv[1]
sys.path.insert(0, root)
sys.path.insert(1, sys.argv[3])
import torch
import chip_smoke as cs
from paddle_tpu_torch import csrc
from paddle_tpu_torch.nn.functional import norm
from paddle_tpu_torch.testing import custom_scale as sc
assert norm.__file__.startswith(root) and sc.__file__.startswith(root)


class Failed(Exception):
    pass


def _raise(msg):
    raise Failed(msg)


cs.fail = _raise
cs.phase_card()
csrc.build_all()
g = torch.Generator(device="cuda").manual_seed(3)
out = {"k3_checks": True, "k9_checks": True}
for dt in (torch.bfloat16, torch.float32):
    for r, d, with_w in cs.LN_BWD_CASES:
        res = cs.ln_bwd_check(*cs.ln_bwd_inputs(r, d, with_w, dt, g))
        out["k3_checks"] &= all(ok for _, ok, _ in res.values())
x, w, gy = cs.ln_bwd_inputs(cs.TRAIN_B * cs.TRAIN_S, 2048, True,
                            torch.bfloat16, g)
out["k3_same_bytes"] = cs.ln_bwd_same_bytes(x, w, gy)
b = torch.randn(2048, generator=g, device="cuda").bfloat16()
_, mean, rstd = torch.ops.aten.native_layer_norm(x, [2048], w, b, 1e-5)
out["k3 [8192, 2048] bf16"] = cs.device_ms(
    lambda: norm.layer_norm_bwd_cuda(x, w, gy, 1e-5), iters=20, reps=11)
out["native_layer_norm_backward"] = cs.device_ms(
    lambda: torch.ops.aten.native_layer_norm_backward(
        gy, x, [2048], mean, rstd, w, b, [True, True, True]),
    iters=20, reps=11)
del x, w, gy, mean, rstd
for name, x, f in cs.scale_cases(g):
    try:
        out["k9_checks"] &= cs.scale_mismatches(x, f)[0] == 0
    except Failed:
        out["k9_checks"] = False
for shape, dt, f in ((cs.SCALE_SHAPE, torch.float32, 2.0),
                     (cs.SCALE_SHAPE, torch.bfloat16, 2.0), cs.FFN_SCALE):
    x = torch.randn(*shape, generator=g, device="cuda").to(dt)
    tag = f"{list(shape)} {str(dt).split('.')[-1]} x{f:g}"
    out["k9 " + tag] = cs.device_ms(lambda: sc.scale_cuda(x, f))
    out["torch.mul " + tag] = cs.device_ms(lambda: torch.mul(x, f))
    del x
print("AB", sys.argv[2], json.dumps(out), flush=True)
"""


def copy_of(root, name, edits=()):
    """A copy of root's paddle_tpu_torch under OUT/name with only KEEP's
    CUDA sources, and ``edits`` [(file, old, new), ...] applied."""
    dst = OUT / "".join(c if c.isalnum() else "_" for c in name)
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(root / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cu in (dst / CSRC).glob("*.cu"):
        if cu.name not in KEEP:
            cu.unlink()
    for path, old, new in edits:
        text = (dst / path).read_text()
        if text.count(old) != 1:
            sys.exit(f"{name}: the edited text is not in {path} exactly once")
        (dst / path).write_text(text.replace(old, new))
    return dst


def times(root, tag):
    run = subprocess.run([sys.executable, "-c", _TIMES, str(root), tag,
                          str(HERE)], cwd=root, capture_output=True,
                         text=True, timeout=900)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
    if run.returncode != 0 or not lines:
        print(f"AB {tag} failed:\n{run.stdout[-3000:]}{run.stderr[-3000:]}",
              flush=True)
        return
    print(lines[-1], flush=True)


_MIX = r"""
import ctypes, glob, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from paddle_tpu_torch import csrc
from paddle_tpu_torch.nn.functional import norm
cs.phase_card()
csrc.build_all()
kern = norm.LAYER_NORM_BWD_KERNEL
new = kern._load()
(lib,) = glob.glob(sys.argv[2] + "/build/paddle_tpu_torch/layer_norm_bwd-*.so")
old = getattr(ctypes.CDLL(lib), kern.symbol)
old.argtypes, old.restype = kern.argtypes, ctypes.c_int
try:
    for tag, fn in (("new", new), ("old", old)):
        kern._fn = fn
        r = cs.phase_train()
        print("MIX", tag, json.dumps(dict(losses=r["losses"],
                                          step_ms=r["step_ms"])), flush=True)
        torch.cuda.empty_cache()
finally:
    kern._fn = new
"""


def main():
    args = [a for a in sys.argv[1:] if a != "--mix"]
    if not args:
        sys.exit(__doc__)
    parent = copy_of(Path(args[0]).resolve(), "parent")
    change = copy_of(HERE, "change")
    names = list(VARIANTS) if args[1:] == ["all"] else args[1:]
    variants = [(n, copy_of(HERE, n, VARIANTS[n])) for n in names]
    for root, tag in [(parent, "parent"), (change, "change"), *(
            (d, n) for n, d in variants), (change, "change"),
            (parent, "parent")]:
        times(root, tag)
    if "--mix" in sys.argv:
        run = subprocess.run([sys.executable, "-c", _MIX, str(HERE),
                              str(parent)], cwd=HERE, capture_output=True,
                             text=True, timeout=1800)
        print("\n".join(ln for ln in run.stdout.splitlines()
                        if ln.startswith("MIX ")) or
              f"MIX failed:\n{run.stdout[-3000:]}{run.stderr[-3000:]}",
              flush=True)


if __name__ == "__main__":
    main()
