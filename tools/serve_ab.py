#!/usr/bin/env python3
"""Time chip_smoke.py's serving phases for two checkouts on one card.

    python3 tools/serve_ab.py PARENT_ROOT

PARENT_ROOT is another checkout of the repository (for example `git
archive <commit>` unpacked under `build/`). Each tree runs in a process of
its own that imports its own `paddle_tpu_torch` and its own
chip_smoke.py (a serving phase checks what its own tree serves: the
parent's admits run eagerly, this tree's from CUDA graphs), phases
`[llama]`, `[serve_cb_llama]`, `[gpt]` and `[serve_cb_gpt]` in that order.
Each prints one line `AB <tag> {...}`: for `[llama]` / `[gpt]` the
prefill ms, decode ms/token and tokens/s of GenerationSession; for
`[serve_cb_*]` TTFT median and p90 (cold and warm), decode ms/token,
ms per generated token, tokens/s, the
chunk's card and host ms, the card's busy share and the peak GiB. The
order is parent, change, change, parent. The trees share their kernel
libraries (named by a hash of their sources, so a tree whose sources
differ builds its own). It needs a card and nvcc.
"""
import gc
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "tools"))
from train_ab import _share_libs  # noqa: E402

PHASES = ("llama", "serve_cb_llama", "gpt", "serve_cb_gpt")
KEYS = ("prefill_ms", "decode_ms_per_token", "ms_per_generated_token",
        "tokens_per_s",
        "ttft_ms_median", "ttft_ms_p90", "ttft_ms_warm_median",
        "ttft_ms_warm_p90", "chunk_card_ms", "chunk_host_ms",
        "card_busy", "peak_gb", "wall_s")


def child(tag, root):
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_phases",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from paddle_tpu_torch import csrc

    csrc.build_all()
    out = {}
    for name in PHASES:
        res = getattr(cs, f"phase_{name}")()
        out[name] = {k: res[k] for k in KEYS if k in res}
        if name.startswith("serve_cb"):
            # a tree whose [serve_cb_*] keeps its model for a later phase
            cs._SERVING_MODELS.clear()
            gc.collect()
    print(f"AB {tag} {json.dumps(out)}", flush=True)


def main():
    if sys.argv[1] == "--child":
        return child(sys.argv[2], Path(sys.argv[3]))
    parent = Path(sys.argv[1]).resolve()
    runs = [("parent", parent), ("change", HERE), ("change", HERE),
            ("parent", parent)]
    rc = 0
    for tag, root in runs:
        _share_libs([parent, HERE])
        rc |= subprocess.run([sys.executable, __file__, "--child", tag,
                              str(root)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
