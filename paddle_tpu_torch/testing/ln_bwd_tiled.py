"""The LayerNorm backward kernel's order of work (K3,
``csrc/layer_norm_bwd.cu``), mirrored in plain PyTorch for the CPU tests.

The kernel cuts the rows into ``n_parts`` balanced, contiguous runs
(``parts``); a CTA owns a run, and a thread of it owns the same columns of
every row: 16-byte vectors of V = 16 / itemsize elements (or, for a d
that is not a multiple of V, single elements), vectors t, t + nt, ... for
thread t of nt (``layout``). Per row it forms

    mean = sum(x) / d
    inv  = rsqrt(sum((x - mean)^2) / d + eps)
    m1   = sum(a) / d,   m2 = inv * sum(a * (x - mean)) / d,   a = g * w
    dx   = inv * (a - m1 - x^ * m2),   x^ = (x - mean) * inv

each sum a block sum (``block_sum``): a thread's elements in order, a
butterfly over each warp's 32 lanes, then the warps in order. A thread
adds g * x^ and g of each row of its run into its dw / db partials in row
order; pass 2 sums the partials of each column in a fixed order (thread
y of RED_SPLIT sums parts y, y + RED_SPLIT, ... in order, then the
RED_SPLIT sums are added in order of y). No float atomics anywhere, so
the result does not depend on scheduling.

``ln_bwd_tiled`` repeats all of that at any dtype on the CPU: the same
partition, the same orders, fp32 throughout, one rounding of each output.
It is not the port's plain version (``_ln_bwd_ref`` in
nn/functional/norm.py is); the tests hold it against that and against the
JAX package's Pallas kernel, so that the kernel's algebra (one centred
pass for var, sum a and sum a * x^ together) and its partition have a CPU
counterpart. The kernel contracts some products into FMAs, so it is not
bit for bit this function. dx as the cp.async-ring kernel forms it; the
shared-memory kernel that serves rows of more than MAX_PIPE_VECS vectors,
or a d that is not a multiple of V, takes its three sums in three
reductions, with the same partition and pass 2.
"""
from __future__ import annotations

import torch

RED_SPLIT = 16  # kRedSplit: threads splitting a column's partials in pass 2
VECS_PER_THREAD = 2   # kVecsPerThread: a thread's vectors of a row
MAX_PIPE_VECS = 512   # kMaxPipeVecs: the longest row of the ring kernel


def parts(rows, n_parts):
    """[(first, end)] of the n_parts balanced, contiguous runs of rows:
    part c is [c * rows // n_parts, (c + 1) * rows // n_parts)."""
    if not 1 <= n_parts <= rows:
        raise ValueError(f"n_parts must be in [1, {rows}], got {n_parts}")
    return [(c * rows // n_parts, (c + 1) * rows // n_parts)
            for c in range(n_parts)]


def threads_for(n):
    """Threads of a CTA for a row of n work items (``ptt::threads_for``):
    n rounded up to a multiple of 32, within [32, 512]."""
    return min(512, max(32, (n + 31) // 32 * 32))


def layout(d, dtype):
    """(V, threads) of a row of d elements of ``dtype``: 16-byte vectors
    when d is a multiple of V, else single elements; the ring kernel
    (rows of at most MAX_PIPE_VECS vectors) gives a thread VECS_PER_THREAD
    of them, the shared-memory kernel as many as 512 threads leave."""
    v = 16 // torch.empty((), dtype=dtype).element_size()
    if d % v:
        return 1, threads_for(d)
    if d // v <= MAX_PIPE_VECS:
        return v, threads_for(-(-(d // v) // VECS_PER_THREAD))
    return v, threads_for(d // v)


def block_sum(t, v, nt):
    """The kernel's sum of each row of t [rows, d] (fp32): thread i of nt
    adds its elements (vectors i, i + nt, ... of v elements) in order,
    each warp's 32 lanes fold as a butterfly (lane 0's sum), then the
    warps' sums are added in order."""
    rows, d = t.shape
    k = -(-d // (v * nt))
    t = torch.nn.functional.pad(t, (0, k * nt * v - d))
    t = t.reshape(rows, k, nt, v)
    s = torch.zeros(rows, nt, dtype=torch.float32)
    for kk in range(k):
        for e in range(v):
            s = s + t[:, kk, :, e]
    s = s.reshape(rows, nt // 32, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    total = torch.zeros(rows, dtype=torch.float32)
    for w in range(nt // 32):
        total = total + s[:, w, 0]
    return total.unsqueeze(-1)


def ln_bwd_tiled(x, weight, g, epsilon, n_parts):
    """(dx in x's dtype, dw, db in the weight's dtype, or x's without a
    weight) of the LayerNorm backward over the last axis of x, g [rows,
    d], in K3's partition into n_parts runs and its orders of summation."""
    rows, d = x.shape
    v, nt = layout(d, x.dtype)
    xf, gf = x.float(), g.float()
    wf = torch.ones(d) if weight is None else weight.float()
    inv_d = torch.tensor(1.0 / d, dtype=torch.float32)
    mean = block_sum(xf, v, nt) * inv_d
    xc = xf - mean
    a = gf * wf
    inv = torch.rsqrt(block_sum(xc * xc, v, nt) * inv_d + epsilon)
    m1 = block_sum(a, v, nt) * inv_d
    m2 = block_sum(a * xc, v, nt) * inv * inv_d
    xh = xc * inv
    dx = (inv * (a - m1 - xh * m2)).to(x.dtype)

    # pass 1: each part's partials, its rows added in order
    runs = parts(rows, n_parts)
    first = torch.tensor([r0 for r0, _ in runs])
    length = torch.tensor([r1 - r0 for r0, r1 in runs])
    part = torch.zeros(n_parts, 2, d, dtype=torch.float32)
    terms = torch.stack([gf * xh, gf], dim=1)   # [rows, 2, d]
    for k in range(int(length.max())):
        live = k < length
        part[live] = part[live] + terms[first[live] + k]
    # pass 2: parts y, y + RED_SPLIT, ... in order, then the sums in order
    total = torch.zeros(2, d, dtype=torch.float32)
    for y in range(RED_SPLIT):
        s = torch.zeros(2, d, dtype=torch.float32)
        for p in range(y, n_parts, RED_SPLIT):
            s = s + part[p]
        total = total + s
    pdt = x.dtype if weight is None else weight.dtype
    return dx, total[0].to(pdt), total[1].to(pdt)


__all__ = ["MAX_PIPE_VECS", "RED_SPLIT", "VECS_PER_THREAD", "block_sum",
           "layout", "ln_bwd_tiled", "parts", "threads_for"]
