#!/usr/bin/env python3
"""Does GPT-3 1.3B's bf16 loss rise survive fp32? (ROADMAP queue C item 12.)

    python3 tools/gpt_loss_rise.py [--quick]

Runs on one card, from the repository root. Trains GPT-3 1.3B
(`gpt3_1p3b()`: E 2048, 16 heads of d=128, vocab 50304) from the weights
of chip_smoke.py's `[train]` phase (`seed(1234, "cuda")`) on its batch
(`np.random.RandomState(0)` tokens), 5 AdamW steps at lr 1e-4 each, in
these runs:

- `bf16 B=4 S=2048 L=24`: `[train]` itself (bf16 amp O2, fp32 masters
  and moments; the bf16 kernel entries);
- `fp32 B=4 S=2048 L=24`: the same model, batch and optimizer in fp32,
  no amp, so every attention and LayerNorm runs the fp32 kernel entries
  (`ptt_flash_fwd_fp32` / `ptt_flash_bwd_fp32`, K2 / K3 in fp32);
- `fp32 B=1 S=256 L=n` for n in 24, 12, 6, 2 (`--quick`: 24 and 2):
  the CPU check's batch shape (`tools/gpt_loss_jax_vs_port.py`), at
  falling depth.

Prints one line `RISE {...}` per run: the losses, the steps whose loss
rose above the one before, the kernels' launch counts and the card.
"""
import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def run(dtype, batch, seq, layers, steps=5):
    """Losses of ``steps`` AdamW steps (lr 1e-4, fp32 masters and moments
    under bf16) of GPT-3 1.3B cut to ``layers`` on one batch."""
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.core import seed
    from paddle_tpu_torch.incubate.nn.functional import flash_attention as fa
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.nn.functional import norm

    cfg = replace(gpt3_1p3b(), num_layers=layers)
    model = GPTForCausalLM(cfg, device="cuda", generator=seed(1234, "cuda"))
    opt = ptt.optimizer.AdamW(parameters=model.parameters(),
                              learning_rate=1e-4, use_multi_tensor=True,
                              multi_precision=True)
    bf16 = dtype == "bf16"
    if bf16:
        model, opt = ptt.amp.decorate(models=model, optimizers=opt,
                                      level="O2", dtype="bfloat16")
    rs = np.random.RandomState(0)
    ids = torch.as_tensor(rs.randint(0, cfg.vocab_size, (batch, seq + 1)),
                          device="cuda")
    x, y = ids[:, :-1], ids[:, 1:]
    kernels = (fa.FLASH_FWD_KERNEL, fa.FLASH_BWD_KERNEL,
               fa.FLASH_FWD_FP32_KERNEL, fa.FLASH_BWD_FP32_KERNEL,
               norm.LAYER_NORM_KERNEL, norm.LAYER_NORM_BWD_KERNEL)
    for k in kernels:
        k.reset_counts()
    losses = []
    for _ in range(steps):
        if bf16:
            with ptt.amp.auto_cast(level="O2", dtype="bfloat16"):
                _, loss = model(x, labels=y)
        else:
            _, loss = model(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    launches = {k.symbol: k.launches for k in kernels}
    plain = sum(k.plain_calls for k in kernels)
    rises = [i + 1 for i in range(steps - 1) if losses[i + 1] > losses[i]]
    del model, opt, x, y, ids
    torch.cuda.empty_cache()
    return dict(run=f"{dtype} B={batch} S={seq} L={layers}", losses=losses,
                rises_at_step=rises, launches=launches, plain_calls=plain)


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a card")
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    depths = (24, 2) if "--quick" in sys.argv else (24, 12, 6, 2)
    plan = [("bf16", 4, 2048, 24), ("fp32", 4, 2048, 24)]
    plan += [("fp32", 1, 256, n) for n in depths]
    for args in plan:
        r = run(*args)
        r["card"] = card
        print("RISE " + json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
