#!/usr/bin/env python3
"""Compare the port's bf16 attention kernels of two checkouts on one card.

    python3 tools/flash_ab.py PARENT_ROOT

PARENT_ROOT is another checkout of the repository (for example `git
archive <commit>` unpacked under `build/`). On one card, in this order:

1. times: card ms (CUDA events over calls in a CUDA graph, chip_smoke's
   `device_ms`) of the head-major forward K6 and backward (K7 at
   GPT-3 1.3B's 2K shape and at TinyLlama's ramp shape, K8 at 2K and at
   16K), bf16 causal, for the parent, this checkout, this checkout and
   the parent, each in a process of its own that builds and imports its
   own kernels. Lines `AB <tag> {...}`.
2. mix: chip_smoke's `[train_llama]` (TinyLlama-1.1B, B=8, S=2048, 5 bf16
   O2 AdamW steps) four times in this checkout, with the native forward
   K4 and backward K5 each taken from this checkout's libraries or from
   the parent's (`ptt_flash_fwd` / `ptt_flash_bwd`, which keep their
   signatures), to see which kernel moves the loss trajectory. Lines
   `MIX <pairing> {...}`.

It needs a card and both checkouts' CUDA sources (built with nvcc into
each checkout's gitignored build/).
"""
import ctypes
import glob
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

# name -> (B, H, D, S, two-kernel backward)
SHAPES = {"K7 gpt": (4, 16, 128, 2048, False),
          "K7 ramp": (8, 32, 64, 2048, False),
          "K8 2K": (4, 16, 128, 2048, True),
          "K8 16K": (1, 16, 128, 16384, True)}

_TIMES = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from paddle_tpu_torch import csrc
from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
assert fa.__file__.startswith(sys.argv[1]), fa.__file__
cs.phase_card()
csrc.build_all()
g = torch.Generator(device="cuda").manual_seed(3)
out = {}
for tag, (b, h, d, s, split) in json.loads(sys.argv[3]).items():
    q, k, v, do = (torch.randn(b * h, s, d, generator=g,
                               device="cuda").bfloat16() for _ in range(4))
    o, lse = fa.flash_fwd_hm_cuda(q, k, v, True)
    bwd = fa.flash_bwd_hm_split_cuda if split else fa.flash_bwd_hm_cuda
    out[tag] = cs.device_ms(lambda: bwd(q, k, v, o, lse, do, True),
                            iters=10, reps=7)
    out["fwd " + tag] = cs.device_ms(
        lambda: fa.flash_fwd_hm_cuda(q, k, v, True), iters=10, reps=7)
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
print("AB", sys.argv[2], json.dumps(out), flush=True)
"""


def times(root, tag):
    run = subprocess.run([sys.executable, "-c", _TIMES, str(root), tag,
                          json.dumps(SHAPES)], cwd=root, capture_output=True,
                         text=True, timeout=900)
    lines = [ln for ln in run.stdout.splitlines() if ln.startswith("AB ")]
    if run.returncode != 0 or not lines:
        sys.exit(f"times of {root} failed:\n{run.stdout[-2000:]}"
                 f"{run.stderr[-2000:]}")
    print(lines[-1], flush=True)


def mix(parent):
    sys.path.insert(0, str(HERE))
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch import csrc
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa

    cs.phase_card()
    csrc.build_all()
    build = subprocess.run(
        [sys.executable, "-c",
         "from paddle_tpu_torch import csrc; csrc.build_all()"],
        cwd=parent, capture_output=True, text=True, timeout=900)
    if build.returncode != 0:
        sys.exit(f"build of {parent} failed:\n{build.stdout[-2000:]}")

    def parent_entry(stem, symbol, kernel):
        (lib,) = glob.glob(f"{parent}/build/paddle_tpu_torch/{stem}-*.so")
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        return fn

    fwd, bwd = fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL
    new = (fwd._load(), bwd._load())
    old = (parent_entry("flash_fwd", "ptt_flash_fwd", fwd),
           parent_entry("flash_bwd", "ptt_flash_bwd", bwd))
    try:
        for tag, f, b in (("new fwd, new bwd", new[0], new[1]),
                          ("old fwd, new bwd", old[0], new[1]),
                          ("new fwd, old bwd", new[0], old[1]),
                          ("old fwd, old bwd", old[0], old[1])):
            fwd._fn, bwd._fn = f, b
            r = cs.phase_train_llama()
            print("MIX", tag, json.dumps(dict(losses=r["losses"],
                                              step_ms=r["step_ms"])),
                  flush=True)
            torch.cuda.empty_cache()
    finally:
        fwd._fn, bwd._fn = new


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    parent = Path(sys.argv[1]).resolve()
    for root, tag in ((parent, "parent"), (HERE, "change"), (HERE, "change"),
                      (parent, "parent")):
        times(root, tag)
    mix(parent)


if __name__ == "__main__":
    main()
