"""The verify programs of speculative decoding, and the acceptance fold.
Counterpart of paddle_tpu/inference/speculative/verify.py.

Both serving sessions score a whole draft window in ONE program:
``run_model(all_logits=True)`` returns fp32 logits at every position of
the token buffer. A window's width varies from step to step (each row
drafts 0..k tokens), so programs are built per WIDTH from a power-of-two
ladder capped at k+1: at most log2(k+1)+1 programs, never one per draft
length. On a card each width is one CUDA graph, built by the session
(``build``: its graph memory pool, its null inputs) at the width's first
use, over static buffers the host refills before each replay; on the CPU
each runs eagerly.

The two acceptance modes of the JAX package:

- "device": the program holds the forward, the acceptance fold
  (``acceptance_fold``) and the rollback of the cached lengths, and
  refreshes the session's last-token vector from the boundary tokens;
  only two int32 vectors (accepted counts, boundary tokens) are read
  back.
- "host": the program writes the argmax chain (greedy) or the fp32
  logits (sampled) to a static buffer; ``fold_host`` runs the same fold
  over them, or the session runs the numpy rules of ``rejection``.

The fold takes its uniforms as an argument: one [rows, cap] draw a
dispatch from the session's Philox generator, of that static shape
whatever the width (the JAX fold draws ``uniform(key, (S, cap))`` from
the window's key), so a test can feed the port's fold the JAX fold's own
uniforms.
"""
from __future__ import annotations

from functools import partial

import torch

__all__ = ["VerifyLadder", "acceptance_fold", "filtered_probs_torch",
           "pow2_width"]


def pow2_width(need: int, cap: int = 0) -> int:
    """Narrowest power-of-two >= need, capped at cap (0 = uncapped)."""
    w = 1
    while w < need:
        w *= 2
    return min(w, cap) if cap else w


def filtered_probs_torch(lv, temperature: float = 1.0, top_k: int = 0,
                         top_p: float = 1.0):
    """Torch mirror of ``rejection.filtered_probs`` (the JAX package's
    ``filtered_probs_jax``): the probability vector(s) the session's
    categorical draw picks from. lv [..., V] -> probs [..., V] (fp32)."""
    lv = lv.float() / max(float(temperature), 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(lv, top_k, dim=-1).values[..., -1:]
        lv = lv.masked_fill(lv < kth, float("-inf"))
    if top_p < 1.0:
        sorted_desc = torch.sort(lv, dim=-1, descending=True).values
        e = torch.exp(sorted_desc - sorted_desc[..., :1])
        probs = e / e.sum(-1, keepdim=True)
        cum = torch.cumsum(probs, dim=-1)
        # clamped as serving.mask_logits clamps: all of cum < top_p can
        # only happen by rounding, and then nothing is cut
        cutoff_idx = torch.clamp((cum < top_p).sum(-1, keepdim=True),
                                 max=lv.shape[-1] - 1)
        cutoff = torch.gather(sorted_desc, -1, cutoff_idx)
        lv = lv.masked_fill(lv < cutoff, float("-inf"))
    lv = lv - lv.max(-1, keepdim=True).values
    e = torch.exp(lv)
    return e / e.sum(-1, keepdim=True)


def _accepted_run(ok):
    """Length of the leading run of True in each row of ok [S, n]."""
    return torch.cumprod(ok.to(torch.int64), dim=1).sum(1)


def acceptance_fold(lv, toks, new_lens, u=None, *, greedy: bool,
                    temperature: float = 1.0, top_k: int = 0,
                    top_p: float = 1.0):
    """(n_accepted [S] int32, boundary [S] int32) from one verify window's
    logits, with no host read (it runs inside the device-accept graph, or
    over harvested logits for host accept).

    lv [S, w, V] fp32 logits at every window position; toks [S, w]
    (column 0 the last committed token, columns 1..m-1 the drafts);
    new_lens [S] window widths (0 = dead row); u [S, cap] uniforms in
    [0, 1), cap >= w (unused under greedy).

    Greedy mirrors ``rejection.greedy_accept``: drafts survive while they
    equal the argmax chain; the boundary is the correction at the first
    mismatch or the bonus after a full window. Sampled mirrors
    ``rejection.rejection_accept`` with a one-hot proposal: draft j is
    accepted iff u[j] < p_j(d_j); the terminal draw is an inverse-cdf
    draw (``searchsorted`` on the right) over the residual (the draft
    zeroed; p itself when the residual is empty) at the first rejection,
    or over p at the bonus position. The uniforms are consumed in the
    host oracle's order: accept tests first (a rejection at j burns
    u[:j+1]), then the terminal draw at n_accepted + rejected."""
    S, w = toks.shape
    dev = lv.device
    m = new_lens.to(torch.int64)
    toks = toks.to(torch.int64)
    pos = torch.arange(max(w - 1, 0), device=dev)[None, :]
    live_pos = pos < m[:, None] - 1
    if greedy:
        arg = lv.argmax(-1)
        n_acc = (_accepted_run((arg[:, :-1] == toks[:, 1:]) & live_pos)
                 if w > 1 else torch.zeros_like(m))
        bound = torch.gather(arg, 1, n_acc[:, None])[:, 0]
        return n_acc.to(torch.int32), bound.to(torch.int32)
    p = filtered_probs_torch(lv, temperature, top_k, top_p)
    rows = torch.arange(S, device=dev)
    if w > 1:
        p_d = torch.gather(p[:, :-1, :], 2, toks[:, 1:, None])[..., 0]
        n_acc = _accepted_run((u[:, :w - 1] < p_d) & live_pos)
    else:
        n_acc = torch.zeros_like(m)
    rejected = n_acc < torch.clamp(m - 1, min=0)
    # the terminal distribution sits at window position n_acc in BOTH
    # outcomes: the rejected position's residual, or (full acceptance)
    # the bonus position's p
    term = p[rows, n_acc]
    d_rej = toks[rows, torch.clamp(n_acc + 1, max=w - 1)]
    V = term.shape[-1]
    zero = rejected[:, None] & (torch.arange(V, device=dev)[None, :]
                                == d_rej[:, None])
    res = term.masked_fill(zero, 0.0)
    dist = torch.where((res.sum(-1) > 0.0)[:, None], res, term)
    cum = torch.cumsum(dist, dim=-1)
    r = u[rows, n_acc + rejected.to(torch.int64)] * cum[:, -1]
    idx = torch.searchsorted(cum, r[:, None].contiguous(), right=True)[:, 0]
    bound = torch.clamp(idx, max=V - 1)
    return n_acc.to(torch.int32), bound.to(torch.int32)


class VerifyLadder:
    """The verify programs of one serving session, one per window width.

    run_model  the session's forward (``make_run_model``)
    rows       the leading dim of every dispatch (slots or batch rows)
    cap        num_draft_tokens + 1 (the widest window)
    pools      callable -> (kcs, vcs, block table, cached lengths): the
               session's static tensors the programs read and write
    build      callable (body, width) -> program: the session's graph
               program (a CUDA graph on a card, eager on the CPU)
    greedy     host accept: the program reduces the logits to the argmax
               chain [rows, w] int32 (a V-fold cut in what is read back);
               device accept: the fold's greedy branch
    accept     "host" or "device" (module docstring)
    sampling   {"do_sample", "temperature", "top_k", "top_p"}: the
               fold's rules; default greedy-vs-sampled from ``greedy``
    generator  the window uniforms' generator: with one, every dispatch
               draws [rows, cap] uniforms, greedy too, so the draw
               schedule is the same in every mode; None draws nothing
               (the batch session accepts with its own host rng)
    last_tok   device accept: the session's last-token vector, refreshed
               from the boundary tokens
    vocab      the vocabulary size (host accept's sampled logits buffer)

    Static buffers, refilled with ``load`` before a replay: ``toks``
    {width: [rows, w] int32}, ``new_lens`` [rows] int32; outputs:
    ``result`` [2, rows] int32 (device accept: accepted counts, boundary
    tokens), ``out`` {width: chain or logits} and ``u`` (host accept).
    """

    def __init__(self, run_model, rows: int, cap: int, device, pools,
                 build, greedy: bool = False, accept: str = "host",
                 sampling=None, generator=None, last_tok=None,
                 vocab: int = 0):
        if accept not in ("host", "device"):
            raise ValueError(f"unknown accept mode {accept!r}")
        if accept == "device" and generator is None:
            raise ValueError("device accept draws its uniforms from the "
                             "session's generator")
        self.rows = int(rows)
        self.cap = int(cap)
        self.greedy = bool(greedy)
        self.accept = accept
        self.device = device
        self._run_model = run_model
        self._pools = pools
        self._build = build
        self._gen = generator
        self._last_tok = last_tok
        self._vocab = int(vocab)
        samp = dict(sampling or {})
        self._fold_kw = dict(
            greedy=not bool(samp.get("do_sample", not greedy)),
            temperature=float(samp.get("temperature", 1.0)),
            top_k=int(samp.get("top_k", 0)),
            top_p=float(samp.get("top_p", 1.0)))
        self.new_lens = self._zeros(self.rows)
        self.result = self._zeros(2, self.rows)
        self.u = self._zeros(self.rows, self.cap, dtype=torch.float32)
        self.toks, self.out, self.programs = {}, {}, {}

    def _zeros(self, *shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def clear(self):
        """Drop every program (the session's weights moved)."""
        self.programs.clear()

    def get(self, need: int):
        """(program, width) for a ``need``-token window; the width's
        program is built at its first use."""
        w = pow2_width(need, self.cap)
        prog = self.programs.get(w)
        if prog is None:
            if w not in self.toks:
                self.toks[w] = self._zeros(self.rows, w)
                if self.accept == "host":
                    self.out[w] = (self._zeros(self.rows, w) if self.greedy
                                   else self._zeros(self.rows, w,
                                                    self._vocab,
                                                    dtype=torch.float32))
            prog = self.programs[w] = self._build(partial(self._body, w), w)
        return prog, w

    def load(self, toks, new_lens):
        """Refill the static buffers from host arrays: toks [rows, w]
        (the width's buffer) and new_lens [rows], int32."""
        with torch.inference_mode():
            self.toks[toks.shape[1]].copy_(torch.from_numpy(toks))
            self.new_lens.copy_(torch.from_numpy(new_lens))

    def _body(self, w):
        """One verify window of width ``w`` over the static buffers. No
        host read anywhere (capturable)."""
        with torch.inference_mode():
            kcs, vcs, bt, seq_lens = self._pools()
            toks, new_lens = self.toks[w], self.new_lens
            lv, _, _, _ = self._run_model(toks, kcs, vcs, bt, seq_lens,
                                          seq_lens, new_lens,
                                          all_logits=True)
            u = (None if self._gen is None else
                 torch.rand((self.rows, self.cap), generator=self._gen,
                            device=self.device, dtype=torch.float32))
            if self.accept == "device":
                n_acc, bound = acceptance_fold(lv, toks, new_lens, u,
                                               **self._fold_kw)
                self.result[0].copy_(n_acc)
                self.result[1].copy_(bound)
                # the rolled-back lengths, from the COMMITTED input
                # lengths: a live row keeps its accepted drafts and the
                # boundary's predecessor, old + n_acc + 1
                seq_lens.copy_(seq_lens + torch.where(new_lens > 0,
                                                      n_acc + 1, 0))
                if self._last_tok is not None:
                    self._last_tok.copy_(bound)
            else:
                self.out[w].copy_(lv.argmax(-1) if self.greedy else lv)
                if u is not None:
                    self.u.copy_(u)

    def fold_host(self, lv, toks, new_lens, u):
        """The device program's fold over harvested logits: the same
        decisions and boundary draws (host accept, sampled)."""
        return acceptance_fold(lv, toks, new_lens, u, **self._fold_kw)
