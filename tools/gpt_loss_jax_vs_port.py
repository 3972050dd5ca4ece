#!/usr/bin/env python3
"""GPT-3 1.3B's width in both packages, from the same weights: do their
fp32 loss trajectories agree where the loss rises? (ROADMAP queue C
item 12; the card's side is tools/gpt_loss_rise.py.)

    python3 tools/gpt_loss_jax_vs_port.py [--layers N] [--out DIR]

Runs on the CPU, in two processes one after the other, so that only one
package's model, gradients and AdamW moments are alive at a time (16
bytes a parameter: about 11 GB at 12 layers):

1. the JAX package's GPTForCausalLM at GPT-3 1.3B's width (E 2048, 16
   heads of d=128, vocab 50304, positions 2048) cut to ``--layers``
   (default 12), weights from ``paddle.seed(21)``, saves them to
   ``DIR/weights.npz`` and takes 5 fp32 AdamW steps (lr 1e-4,
   ``paddle.jit.to_static``, as tests/test_torch_train.py's 2-layer
   check) on one batch of B=1, S=256 tokens from
   ``np.random.RandomState(--data-seed)`` (default 5);
2. the port's model loads those weights (bridge.load_jax_state) and
   takes the same 5 steps on the same batch.

Prints the two trajectories, the steps where each rises, and the largest
relative gap; the last line is one JSON object with all of them. DIR
defaults to build/gpt_loss_check under the repository root.
"""
import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=50304, hidden_size=2048, num_heads=16, max_seq_len=2048)


def _batch(data_seed):
    ids = np.random.RandomState(data_seed).randint(0, 50304, (1, 257))
    return ids[:, :-1].astype(np.int64), ids[:, 1:].astype(np.int64)


def run_jax(layers, out, data_seed):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTForCausalLM

    paddle.seed(21)
    jm = GPTForCausalLM(GPTConfig(num_layers=layers, **KW))
    np.savez(out / "weights.npz", **{k: np.asarray(v._value)
                                     for k, v in jm.state_dict().items()})
    opt = paddle.optimizer.AdamW(parameters=jm.parameters(),
                                 learning_rate=1e-4, use_multi_tensor=True,
                                 multi_precision=True)

    @paddle.jit.to_static(state_objects=[jm, opt])
    def step(x_, y_):
        _, loss = jm(x_, labels=y_)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    x, y = _batch(data_seed)
    losses = [float(np.asarray(step(paddle.to_tensor(x),
                                    paddle.to_tensor(y)).numpy()))
              for _ in range(5)]
    (out / f"jax_losses_{data_seed}.json").write_text(json.dumps(losses))


def run_port(layers, out, data_seed):
    import torch

    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.bridge import load_jax_state
    from paddle_tpu_torch.models import gpt as tgpt

    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig(num_layers=layers, **KW),
                             device="cpu")
    with np.load(out / "weights.npz") as w:
        load_jax_state(tm, {k: w[k] for k in w.files})
    opt = ptt.optimizer.AdamW(parameters=tm.parameters(), learning_rate=1e-4,
                              use_multi_tensor=True, multi_precision=True)
    x, y = (torch.tensor(a) for a in _batch(data_seed))
    losses = []
    for _ in range(5):
        _, loss = tm(x, labels=y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    (out / f"port_losses_{data_seed}.json").write_text(json.dumps(losses))


def _rises(losses):
    return [i + 1 for i in range(len(losses) - 1)
            if losses[i + 1] > losses[i]]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--out", default=str(REPO / "build" / "gpt_loss_check"))
    ap.add_argument("--data-seed", type=int, default=5)
    ap.add_argument("--side", choices=("jax", "port"))
    a = ap.parse_args()
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(REPO))
    if a.side == "jax":
        return run_jax(a.layers, out, a.data_seed)
    if a.side == "port":
        return run_port(a.layers, out, a.data_seed)
    for side in ("jax", "port"):
        subprocess.run([sys.executable, __file__, "--side", side,
                        "--layers", str(a.layers), "--out", str(out),
                        "--data-seed", str(a.data_seed)], check=True)
    jl = json.loads((out / f"jax_losses_{a.data_seed}.json").read_text())
    tl = json.loads((out / f"port_losses_{a.data_seed}.json").read_text())
    gap = max(abs(t - j) / abs(j) for t, j in zip(tl, jl))
    print(f"layers {a.layers}: jax {jl} (rises at {_rises(jl)}); port {tl} "
          f"(rises at {_rises(tl)}); largest relative gap {gap:.3g}")
    print(json.dumps(dict(layers=a.layers, data_seed=a.data_seed, jax=jl,
                          port=tl,
                          jax_rises=_rises(jl), port_rises=_rises(tl),
                          max_rel_gap=gap)))


if __name__ == "__main__":
    main()
