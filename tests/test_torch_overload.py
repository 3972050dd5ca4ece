"""The scheduler's overload paths in the port's ContinuousBatchingSession
against the JAX package's.

Shadows tests/test_zserving_overload.py :123 (cancellation and deadline
expiry), :166 (chunked prefill byte equality), :184 (forced preemption),
:205 (preemption regenerating through the prefix cache), :263 (priority
admission and automatic preemption) and :455 (Llama-GQA, chunked prefill
and a forced preemption), on the reference's tiny GPT (vocab 512, E 64,
2 layers, 2 heads, max_seq_len 64) and a Llama-GQA of the same size, in
fp32 with the JAX model's weights (bridge.load_jax_state). Every scenario
runs on a JAX session (sequential engine, overlap=False) and on the
port's: streams, statuses and ``stats`` must be equal, and every stream
that finished must equal the port's unchunked, unloaded session's, byte
for byte. Deadlines expire through a patched clock, never a sleep. Also
here: the ``kv_pool_bytes`` geometry against the JAX session's, and the
admit widths that chunking selects.

Sessions are module-scoped, as in the reference file: each JAX session
compiles its executables once.
"""
import gc
import time

import numpy as np
import pytest

from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.inference import serving as tserving

from test_torch_continuous_batching import make_cb_pair, session

GPT_KW = dict(max_seq_len=64)
SESS_KW = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=2,
               num_blocks=12)


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Sessions are reference cycles whose memz and flight-recorder
    providers stay registered until the collector frees them: free this
    file's before the next file in the process runs."""
    yield
    gc.collect()


@pytest.fixture(scope="module")
def gpt_pair():
    return make_cb_pair("gpt", seed=0, **GPT_KW)


@pytest.fixture(scope="module")
def sessions(gpt_pair):
    """{name: session}: the port's unchunked session (the unloaded
    reference run) and, in both packages, the chunked one."""
    jm, tm = gpt_pair
    return {"plain": session(tm, **SESS_KW),
            "jax": session(jm, prefill_chunk=3, **SESS_KW),
            "port": session(tm, prefill_chunk=3, **SESS_KW)}


def _pkg(sess):
    return (tserving if isinstance(sess, tserving.ContinuousBatchingSession)
            else jserving)


def _reference(sess, reqs):
    """Solo greedy run of (rid, prompt, max_new) on an idle session."""
    sess.run()
    for rid, p, mn in reqs:
        sess.submit(tserving.Request(f"ref_{rid}", p, mn))
    return {rid[4:]: toks for rid, toks in sess.run().items()}


def _both(sessions, scenario):
    """scenario(session, Request class) on the JAX and the port's chunked
    sessions; their results and stats must be equal. Returns the port's
    result."""
    res = {}
    for name in ("jax", "port"):
        sess = sessions[name]
        res[name] = (scenario(sess, _pkg(sess).Request), sess.stats)
    got, want = res["port"], res["jax"]
    assert got[1] == want[1]
    assert set(got[0]) == set(want[0])
    for k in got[0]:
        np.testing.assert_equal(got[0][k], want[0][k], err_msg=str(k))
    return got[0]


def _mk(rs, n):
    return rs.randint(1, 500, (n,)).astype(np.int64)


class _Clock:
    """time.monotonic, moved ``ahead`` seconds into the future."""

    def __init__(self):
        self.ahead, self._real = 0.0, time.monotonic

    def __call__(self):
        return self._real() + self.ahead


def test_cancel_and_deadline_expiry_equal_jax(sessions, monkeypatch):
    """Shadows test_zserving_overload.py:123: a waiting and a running
    request cancelled; a waiting and a running request whose deadline
    passes (the clock moved past it, no sleep) expire. The slots and
    blocks come back at once, in both packages alike."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    p = _mk(np.random.RandomState(5), 9)

    def scenario(sess, Request):
        clock.ahead = 0.0
        sess.run()
        sess.submit(Request("cw", p, 50))
        sess.cancel("cw")
        sess.submit(Request("cr", p, 50))
        for _ in range(4):
            sess.step()
        running = [s.req.req_id for s in sess._slots if s.req is not None]
        sess.cancel("cr")
        sess._pool.assert_quiescent()
        sess.submit(Request("dl", p, 50, deadline_s=5.0))
        clock.ahead = 10.0                 # past dl's deadline, waiting
        sess.step()
        clock.ahead = 0.0
        sess.submit(Request("dr", p, 50, deadline_s=1000.0))
        for _ in range(3):
            sess.step()
        live = [s.req.req_id for s in sess._slots if s.req is not None]
        clock.ahead = 2000.0               # past dr's deadline, running
        sess.step()
        out = {r.req_id: (r.status, list(r.tokens)) for r in sess._completed
               if r.req_id in ("cw", "cr", "dl", "dr")}
        sess._completed = []
        sess._pool.assert_quiescent()
        clock.ahead = 0.0
        return dict(out, running=running, live=live)

    got = _both(sessions, scenario)
    assert got["running"] == ["cr"] and got["live"] == ["dr"]
    assert got["cw"] == ("cancelled", [])
    assert got["cr"][0] == "cancelled" and 0 < len(got["cr"][1]) < 50
    assert got["dl"] == ("expired", [])
    assert got["dr"][0] == "expired" and 0 < len(got["dr"][1]) < 50


def test_chunked_prefill_byte_equality_equal_jax(sessions):
    """Shadows test_zserving_overload.py:166: prefill_chunk=3 streams the
    unchunked session's bytes; the 16-token prompt alone needs
    ceil(16/3) = 6 admits."""
    rs = np.random.RandomState(11)
    reqs = [(f"c{i}", _mk(rs, n), 6) for i, n in enumerate((16, 5, 13, 9))]
    ref = _reference(sessions["plain"], reqs)

    def scenario(sess, Request):
        sess.run()
        base = sess.stats["admit_steps"]
        for rid, p, mn in reqs:
            sess.submit(Request(rid, p, mn))
        out = sess.run()
        out["admits"] = sess.stats["admit_steps"] - base
        return out

    got = _both(sessions, scenario)
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)
    assert got["admits"] >= 6


def test_forced_preemption_byte_equality_equal_jax(sessions):
    """Shadows test_zserving_overload.py:184: preempt() mid-decode sends
    the default victim back to the queue; it regenerates the unloaded
    stream."""
    rs = np.random.RandomState(12)
    reqs = [("pa", _mk(rs, 10), 8), ("pb", _mk(rs, 7), 8)]
    ref = _reference(sessions["plain"], reqs)

    def scenario(sess, Request):
        sess.run()
        base = sess.stats["preemptions"]
        for rid, p, mn in reqs:
            sess.submit(Request(rid, p, mn))
        for _ in range(6):
            sess.step()
        victim = sess.preempt()
        out = sess.run()
        out["victim"] = victim
        out["preempted"] = sess.stats["preemptions"] - base
        return out

    got = _both(sessions, scenario)
    assert got["preempted"] == 1 and got["victim"] in ("pa", "pb")
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)


def test_prefix_hit_regeneration_equal_jax(sessions):
    """Shadows test_zserving_overload.py:205: a preempted request whose
    prompt lives in the prefix cache re-admits through it (its history
    matched at least one full block) and still streams the unloaded
    bytes."""
    p = _mk(np.random.RandomState(13), 16)
    ref = _reference(sessions["plain"], [("h1", p, 8)])

    def scenario(sess, Request):
        sess.run()
        sess.submit(Request("h0", p, 4))           # prime the cache
        sess.run()
        req = Request("h1", p, 8)
        sess.submit(req)
        for _ in range(4):
            sess.step()
        assert [s.req for s in sess._slots if s.req is not None] == [req]
        assert len(req.tokens) > 0
        sess.preempt()
        status = req.status
        out = sess.run()
        return dict(h1=out["h1"], status=status,
                    preemptions=req.preemptions, hit=req.prefix_hit_tokens)

    got = _both(sessions, scenario)
    np.testing.assert_array_equal(got["h1"], ref["h1"])
    assert got["status"] == "preempted" and got["preemptions"] == 1
    assert got["hit"] >= SESS_KW["kv_block_size"]


def test_priority_admission_and_auto_preemption_equal_jax(sessions):
    """Shadows test_zserving_overload.py:263: an equal-priority arrival
    waits (no thrash); a strictly higher one preempts the lowest-priority,
    most recently admitted victim and is admitted in the same step; every
    stream equals its unloaded run and the pool drains."""
    rs = np.random.RandomState(15)
    reqs = [("lo0", _mk(rs, 8), 10), ("lo1", _mk(rs, 8), 10),
            ("hi", _mk(rs, 8), 4)]
    eq = _mk(rs, 5)
    ref = _reference(sessions["plain"], reqs)

    def scenario(sess, Request):
        sess.run()
        base = sess.stats["preemptions"]
        sess.submit(Request("lo0", reqs[0][1], 10, priority=0))
        sess.submit(Request("lo1", reqs[1][1], 10, priority=0))
        for _ in range(5):
            sess.step()
        sess.submit(Request("eq", eq, 2, priority=0))
        sess.step()
        eq_waited = ((sess.stats["preemptions"] == base)
                     and "eq" in [r.req_id for r in sess._queue])
        sess.cancel("eq")
        sess.submit(Request("hi", reqs[2][1], 4, priority=5))
        sess.step()
        hi_in = [s.req.req_id for s in sess._slots if s.req is not None]
        preempted = sess.stats["preemptions"] - base
        out = sess.run()
        sess._pool.assert_quiescent()
        out.pop("eq", None)
        return dict(out, eq_waited=eq_waited, hi_in=hi_in,
                    preempted=preempted)

    got = _both(sessions, scenario)
    assert got["eq_waited"] and got["preempted"] == 1
    assert "hi" in got["hi_in"]
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)


def test_chunked_and_preemption_llama_gqa_equal_jax():
    """Shadows test_zserving_overload.py:455: Llama with grouped query
    (4 heads over 2 kv heads), prefill_chunk=3 and a forced preemption
    after 5 steps: the JAX session's streams and stats, and the port's
    unchunked session's streams."""
    jm, tm = make_cb_pair("llama", seed=3)
    kw = dict(slots=2, max_prompt_len=12, kv_block_size=4, chunk=4,
              num_blocks=16)
    rs = np.random.RandomState(21)
    reqs = [(f"L{i}", rs.randint(1, 500, (n,)).astype(np.int64), 6)
            for i, n in enumerate((12, 5, 9))]
    ref = _reference(session(tm, **kw), reqs)
    res = {}
    for name, m, pkg in (("jax", jm, jserving), ("port", tm, tserving)):
        sess = session(m, prefill_chunk=3, **kw)
        for rid, p, mn in reqs:
            sess.submit(pkg.Request(rid, p, mn))
        for _ in range(5):
            sess.step()
        sess.preempt()
        res[name] = (sess.run(), sess.stats)
        sess._pool.assert_quiescent()
    (got, st), (want, jst) = res["port"], res["jax"]
    assert st == jst and st["preemptions"] == 1
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)


@pytest.mark.parametrize("budget,num_blocks,env", [
    (40_000, None, None),            # the budget sizes the pool
    (40_000, 9, None),               # num_blocks wins over it
    (None, None, "50000"),           # the environment's default budget
    (100, None, None),               # below one block: one block
])
def test_kv_pool_bytes_geometry_equal_jax(gpt_pair, monkeypatch, budget,
                                          num_blocks, env):
    """The equal-byte-budget pool geometry of the JAX session
    (paddle_tpu/inference/serving.py:1548): block count, pool bytes,
    the scheduler's knobs and the memz detail equal the JAX session's."""
    if env is None:
        monkeypatch.delenv("PADDLE_SERVING_QUANT_KV_POOL_BYTES",
                           raising=False)
    else:
        monkeypatch.setenv("PADDLE_SERVING_QUANT_KV_POOL_BYTES", env)
    jm, tm = gpt_pair
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=2,
              num_blocks=num_blocks, kv_pool_bytes=budget)
    j, t = session(jm, **kw), session(tm, **kw)
    assert t._num_blocks == j._num_blocks >= 1
    assert t._kv_pool_bytes == j._kv_pool_bytes
    assert t._cache_shape[0] == t._num_blocks and t._kcs[0].shape[0] == (
        t._num_blocks)
    knobs = ("num_blocks", "kv_pool_bytes", "prefill_chunk", "slots")
    jk, tk = j.scheduler.snapshot()["knobs"], t.scheduler.snapshot()["knobs"]
    assert {k: tk[k] for k in knobs} == {k: jk[k] for k in knobs}
    from paddle_tpu_torch.observability.memz import memz_snapshot

    mine = memz_snapshot()["providers"][f"serving_session_{id(t):x}"]
    assert mine["components"]["kv_pool"] == t._kv_pool_bytes
    assert mine["detail"]["kv_pool"]["kv_pool_bytes"] == t._kv_pool_bytes


def test_kv_pool_bytes_binding_pool_streams_equal_jax(gpt_pair):
    """A budget of 6 blocks, fewer than two of the requests hold at once:
    admissions wait for blocks and evict cached ones, in both packages
    alike, and every stream equals the unbounded session's."""
    jm, tm = gpt_pair
    block = tserving.get_model_adapter(tm)
    from paddle_tpu_torch.incubate.nn.functional.paged_kv import \
        kv_block_bytes

    one = kv_block_bytes(block.num_layers, block.kv_heads, 8,
                         block.head_dim)
    rs = np.random.RandomState(31)
    reqs = [(f"b{i}", _mk(rs, n), 12) for i, n in enumerate((14, 9, 16, 6))]
    ref = _reference(session(tm, slots=2, max_prompt_len=16,
                             kv_block_size=8, chunk=2), reqs)
    res = {}
    for m, pkg in ((jm, jserving), (tm, tserving)):
        sess = session(m, slots=2, max_prompt_len=16, kv_block_size=8,
                       chunk=2, prefill_chunk=4, kv_pool_bytes=6 * one + 7)
        assert sess._num_blocks == 6
        for rid, p, mn in reqs:
            sess.submit(pkg.Request(rid, p, mn))
        res[pkg] = (sess.run(), sess.stats)
        sess._pool.assert_quiescent()
    (got, st), (want, jst) = res[tserving], res[jserving]
    assert st == jst and st["prefix_evictions"] >= 1
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
        np.testing.assert_array_equal(got[rid], ref[rid], err_msg=rid)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_admit_widths_follow_the_chunk_ladder(gpt_pair, prefix_cache):
    """The admit token-buffer width is the narrowest power of two over the
    longest chunk whenever chunked prefill or the prefix cache is on
    (max_prompt_len only with both off, tests/test_torch_prefix_cache.py),
    as the JAX package's ``_admit_exec`` picks its executables: with
    prefill_chunk=3 the widths used are the JAX session's compiled ones,
    each admit program is built once per width, and width max_prompt_len
    is built with the session, as the JAX session pins it."""
    jm, tm = gpt_pair
    kw = dict(slots=2, max_prompt_len=16, kv_block_size=8, chunk=2,
              prefill_chunk=3, prefix_cache=prefix_cache)
    rs = np.random.RandomState(41)
    reqs = [(f"w{i}", _mk(rs, n), 3) for i, n in enumerate((16, 2, 7))]
    j, t = session(jm, **kw), session(tm, **kw)
    widths = []
    admit = t._admit
    t._admit = lambda toks, lens, cow: (widths.append(toks.shape[1]),
                                        admit(toks, lens, cow))[1]
    for sess, pkg in ((j, jserving), (t, tserving)):
        for rid, p, mn in reqs:
            sess.submit(pkg.Request(rid, p, mn))
    want, got = j.run(), t.run()
    for rid, _, _ in reqs:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert set(widths) <= {1, 2, 4}
    # both sessions also build width max_prompt_len up front
    assert set(t._admit_progs) == set(widths) | {16} == set(
        j._admit_compiled)
    assert t.stats == j.stats
