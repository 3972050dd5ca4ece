#!/usr/bin/env python3
"""Time the overlapped engine against the sequential one on one card.

    python3 tools/engine_ab.py [FAMILY ...] [--rounds N]

FAMILY is `llama` (Llama-2-7B) or `gpt` (GPT-3 1.3B), both by default;
each is chip_smoke.py's serving model (bf16, random weights from its
seed). The family's `[serve_cb_*]` traffic (chip_smoke `cb_prompts`, its
two waves) runs through `chip_smoke.engine_drive` on the sequential
(`seq`) and the overlapped (`ovl`) engine in the order seq, ovl, ovl,
seq, N rounds (default 3), each run a fresh session serving the traffic
twice. Each run prints one line `AB <family> <engine> {...}`: the warm
pass's ms per generated token and wall, the card's busy share over its
decode stretches, and the staged and mispredicted steps. It needs a card
and nvcc; run it from the repository root.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("families", nargs="*", default=["llama", "gpt"])
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import chip_smoke as cs
    from paddle_tpu_torch.incubate.nn.functional import fused_ops
    from paddle_tpu_torch.nn.functional import norm

    cs.phase_card()
    cs.phase_build()
    for family in args.families:
        kernel, other = (
            (fused_ops.RMS_NORM_KERNEL, norm.LAYER_NORM_KERNEL)
            if family == "llama"
            else (norm.LAYER_NORM_KERNEL, fused_ops.RMS_NORM_KERNEL))
        model = cs.serving_model(family)
        prompts = cs.cb_prompts(model.cfg.vocab_size)
        pf = 2 * model.cfg.num_layers + 1
        for _ in range(args.rounds):
            for engine in ("seq", "ovl", "ovl", "seq"):
                run = cs.engine_drive(model, prompts, f"{family} {engine}",
                                      kernel, other, pf,
                                      overlap=engine == "ovl")
                w = run["warm"]
                print(f"AB {family} {engine} " + json.dumps(dict(
                    ms_per_generated_token=w["ms_per_generated_token"],
                    wall_s=w["wall_s"], card_busy=w["card_busy"],
                    staged=w["overlapped"], mispredicts=w["mispredicts"],
                    steps=w["steps"])), flush=True)
        cs._release_serving_model(family)
        gc.collect()


if __name__ == "__main__":
    main()
