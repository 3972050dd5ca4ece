#!/usr/bin/env python3
"""Time chip_smoke.py's training phases for two checkouts on one card.

    python3 tools/train_ab.py PARENT_ROOT [VARIANT ...]

PARENT_ROOT is another checkout of the repository (for example `git
archive <commit>` unpacked under `build/`). Each tree runs in a process of
its own that imports its own `paddle_tpu_torch` and runs this checkout's
chip_smoke.py phases `[train]`, `[train_fused]`, `[train_long]` and
`[train_llama]` (bf16 O2 AdamW with fp32 masters and moments), and
`[train_recipe]` in every tree but the parent's (which predates it).
Each prints one line `AB <tag> {...}`: per phase (and recipe model) the
host-clock step ms, the card ms of one step under the profiler, the
card's busy share, the peak GiB and the five losses. The order is
parent, change, each named VARIANT, change, parent.

A variant is this checkout with a few text edits (`VARIANTS`: file, old
text, new text; each old text must occur exactly once), copied under
`build/train_ab/`. The trees share their kernel libraries (named by a
hash of their sources, so a tree whose sources differ builds its own).
It needs a card and nvcc.
"""
import importlib.util
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "train_ab"
LIBS = Path("build") / "paddle_tpu_torch"
PHASES = ("train", "train_fused", "train_long", "train_llama")
_OPT = Path("paddle_tpu_torch") / "optimizer" / "optimizers.py"

# name -> [(file, old text, new text), ...]
VARIANTS = {
    "index_select embedding": [(
        Path("paddle_tpu_torch") / "nn" / "functional" / "common.py",
        "    return torch.nn.functional.embedding(x, weight)\n",
        "    return weight.index_select(0, x.reshape(-1)).reshape("
        "*x.shape, -1)\n")],
    # every parameter in an update of its own: what a step's per-tensor
    # `_foreach` passes cost against one pass over the fp32-state ones
    "per-tensor updates": [
        (_OPT, "        groups = [in_place] if in_place else []\n",
         "        groups = [[pg] for pg in in_place]\n"),
        (_OPT, "    _GROUP_NUMEL = 1 << 26\n", "    _GROUP_NUMEL = 1\n")],
}


def _variant_root(name):
    root = OUT / name.replace(" ", "_")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(HERE / "paddle_tpu_torch", root / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, old, new in VARIANTS[name]:
        f = root / rel
        text = f.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"variant {name!r}: {rel} holds its old text "
                             f"{text.count(old)} times")
        f.write_text(text.replace(old, new))
    return root


def _share_libs(roots):
    """Copy every kernel library one tree built into the others."""
    libs = {}
    for r in roots:
        for so in (r / LIBS).glob("*.so"):
            libs.setdefault(so.name, so)
    for r in roots:
        (r / LIBS).mkdir(parents=True, exist_ok=True)
        for name, so in libs.items():
            if not (r / LIBS / name).exists():
                shutil.copy2(so, r / LIBS / name)


def _summary(res):
    keys = ("step_ms", "step_device_ms", "device_busy", "peak_gb", "losses")
    return {k: res.get(k) for k in keys}


def child(tag, root, recipe):
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_phases",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import csrc

    csrc.build_all()
    out = {}
    for name in PHASES:
        out[name] = _summary(getattr(cs, f"phase_{name}")())
    if recipe:
        for model, res in cs.phase_train_recipe().items():
            out[f"train_recipe {model}"] = _summary(res)
    print(f"AB {tag} {json.dumps(out)}", flush=True)


def main():
    if sys.argv[1] == "--child":
        return child(sys.argv[2], Path(sys.argv[3]), sys.argv[4] == "1")
    parent = Path(sys.argv[1]).resolve()
    runs = [("parent", parent), ("change", HERE)]
    runs += [(name, _variant_root(name)) for name in sys.argv[2:]]
    runs += [("change", HERE), ("parent", parent)]
    roots = list(dict.fromkeys(r for _, r in runs))
    rc = 0
    for tag, root in runs:
        _share_libs(roots)
        recipe = "0" if tag == "parent" else "1"
        rc |= subprocess.run([sys.executable, __file__, "--child", tag,
                              str(root), recipe]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
