#!/usr/bin/env python3
"""Where a ContinuousBatchingSession's admit capture spends its time.

    python3 tools/capture_breakdown.py

Runs on one card, from the repository root. For GPT-3 1.3B and
Llama-2-7B (chip_smoke.py's serving models: bf16, random weights from
seed 1234) it builds chip_smoke's [serve_cb_*] session and, for the admit
at token-buffer widths 8, 64, 128 and 256, times the steps of a capture
one by one, over the session's null inputs: a full gc.collect(), the
warm-up forward (host, then with the card), the recording between
capture_begin and capture_end, instantiation, the first and second
replay, and the same admit run eagerly. Host milliseconds, one line per
width and a last line `BREAKDOWN {...}` with all of them.
"""
import gc
import json
import sys
import time
from functools import partial
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

WIDTHS = (8, 64, 128, 256)


def _ms(t0):
    return round((time.perf_counter() - t0) * 1e3, 2)


def breakdown(sess, w):
    """{step: host ms} of capturing, replaying and eagerly running the
    admit program of width ``w`` of ``sess``."""
    dev = torch.device("cuda")
    body = partial(sess._admit_body, w)
    sess._admit_toks[w] = torch.zeros((cs.CB_SLOTS, w), dtype=torch.int32,
                                      device=dev)
    t = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gc.collect()
    t["gc"] = _ms(t0)
    gc.disable()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.enable_debug_mode()
    with sess._null_inputs():
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            body()
            t["warm-up host"] = _ms(t0)
            torch.cuda.synchronize()
            t["warm-up card+host"] = _ms(t0)
            t0 = time.perf_counter()
            graph.capture_begin(sess._graph_pool)
            body()
            graph.capture_end()
            t["record"] = _ms(t0)
        torch.cuda.current_stream(dev).wait_stream(side)
    gc.enable()
    for step, fn in (("instantiate", graph.instantiate),
                     ("first replay", graph.replay),
                     ("second replay", graph.replay)):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t[step] = _ms(t0)
    t0 = time.perf_counter()
    with sess._null_inputs():
        body()
    torch.cuda.synchronize()
    t["eager admit"] = _ms(t0)
    return t


def main():
    if not torch.cuda.is_available():
        sys.exit("this script needs a card")
    cs.phase_build()
    out = {}
    for family in ("gpt", "llama"):
        sess = cs.cb_session(cs.serving_model(family))
        out[family] = {}
        for w in WIDTHS:
            out[family][w] = breakdown(sess, w)
            print(family, w, out[family][w], flush=True)
        del sess
        cs._SERVING_MODELS.clear()
        gc.collect()
        torch.cuda.empty_cache()
    print("BREAKDOWN", json.dumps(out))


if __name__ == "__main__":
    main()
