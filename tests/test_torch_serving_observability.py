"""The port's serving telemetry against the JAX package's.

The port's ContinuousBatchingSession, driven through run() as the verify
skill's telemetry flow drives the reference's (tests/test_observability.py
:288 and :471, tests/test_tracing.py:171 without speculation), must:
- render serving_ttft_seconds_bucket, serving_tpot_seconds_bucket and
  serving_kv_pool_occupancy, lint-clean, with counts that match the run;
- emit one serving.request_done event per request;
- with observability=1, trace_sample_rate=1.0, give each request
  queue_wait, admit and decode spans whose phases tile its lifetime;
- produce the metric families, types and label sets of the JAX session
  on the same requests, except the families that read the JAX runtime
  (the jax.monitoring bridge's jax_*; XLA cost analysis's
  engine_program_flops / engine_program_bytes_accessed);
- serve byte-identical tokens with the flag off, recording nothing.
"""
import gc

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as jobs
import paddle_tpu_torch as ptt
import paddle_tpu_torch.observability as tobs
from paddle_tpu.inference import serving as jserving
from paddle_tpu_torch.inference import serving as tserving

from test_torch_continuous_batching import make_cb_pair, session

# families that exist only where the JAX runtime feeds them
JAX_ONLY = ("jax_", "engine_program_flops", "engine_program_bytes_accessed")


@pytest.fixture(scope="module", autouse=True)
def _collect_sessions():
    """Sessions are reference cycles whose memz providers stay registered
    until the collector frees them: free this file's before the next
    file in the process runs."""
    yield
    gc.collect()


@pytest.fixture
def flags():
    """Both packages' observability flags, restored after the test."""
    names = ("observability", "trace_sample_rate")
    jprev = {n: paddle.get_flags([n])[n] for n in names}
    tprev = {n: ptt.core.get_flag(n) for n in names}

    def set_both(**kw):
        paddle.set_flags(kw)
        ptt.set_flags(kw)
    try:
        yield set_both
    finally:
        paddle.set_flags(jprev)
        ptt.set_flags(tprev)


def _fresh(obs):
    reg = obs.get_registry()
    reg.reset()
    obs.get_event_log().clear()
    obs.get_tracer().reset()
    return reg, obs.get_event_log()


def _corpus():
    rs = np.random.RandomState(8)
    shared = rs.randint(1, 250, (8,)).astype("int64")
    pb = np.concatenate([shared, rs.randint(1, 250, (4,)).astype("int64")])
    return [[("prime", pb, 4)],
            [("a", shared.copy(), 6), ("b", pb, 6),
             ("c", rs.randint(1, 250, (5,)).astype("int64"), 5)]]


def _drive(model, pkg):
    """Two waves through run(): a prime, then a full hit (CoW), a partial
    hit and a miss over 2 slots. Returns {req_id: tokens}."""
    sess = session(model, slots=2, max_prompt_len=12, kv_block_size=4,
                   chunk=3)
    out = {}
    for wave in _corpus():
        for rid, p, n in wave:
            sess.submit(pkg.Request(rid, p, n))
        out.update(sess.run())
    return out, sess


def _families(reg):
    """{name: (type, sorted label-key sets)} of a registry snapshot."""
    fam = {}
    for name, m in reg.to_dict().items():
        if name.startswith(JAX_ONLY):
            continue
        keys = sorted({tuple(sorted(k for k in v["labels"]))
                       for v in m["values"]})
        fam[name] = (m["type"], keys)
    return fam


def test_serving_telemetry_exports_and_matches_jax_families(flags):
    """Prometheus families, request_done events and metric names / label
    sets of the port's session equal the JAX session's."""
    flags(observability=1, trace_sample_rate=1.0)
    jm, tm = make_cb_pair("gpt", seed=17, vocab_size=256, hidden_size=32,
                          max_seq_len=64)
    jreg, jlog = _fresh(jobs)
    want, jsess = _drive(jm, jserving)
    reg, log = _fresh(tobs)
    got, sess = _drive(tm, tserving)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    txt = tobs.render_prometheus()
    for fam in ("serving_ttft_seconds_bucket", "serving_tpot_seconds_bucket",
                "serving_kv_pool_occupancy", "paged_kv_prefix_cache_blocks",
                'paged_kv_blocks{state="cached"}'):
        assert fam in txt, fam
    assert tobs.lint_prometheus(txt) == []
    assert reg.get("serving_ttft_seconds").value()["count"] == 4
    assert reg.get("serving_queue_wait_seconds").value()["count"] == 4
    assert reg.counter("serving_requests_completed_total").value() == 4
    for name in ("serving_prefix_cache_hits_total",
                 "serving_prefix_cache_cow_total",
                 "serving_prefix_hit_tokens_total",
                 "serving_prefill_tokens_total", "serving_tokens_total",
                 "serving_admit_steps_total", "serving_chunk_steps_total"):
        assert (reg.counter(name).value()
                == jreg.counter(name).value()), name
    brk = reg.gauge("paged_kv_blocks")
    assert sum(brk.value(state=s) for s in
               ("referenced", "cached", "free")) == sess._num_blocks
    done = {d["req_id"]: d for d in log.events("serving.request_done")}
    jdone = {d["req_id"]: d for d in jlog.events("serving.request_done")}
    assert len(log.events("serving.request_done")) == 4
    assert set(done) == set(jdone) == {"prime", "a", "b", "c"}
    for rid, d in done.items():
        assert set(d) == set(jdone[rid])
        for k in ("prompt_len", "n_tokens", "prefix_hit_tokens",
                  "block_hashes", "eos"):
            assert d[k] == jdone[rid][k], (rid, k)
        assert d["ttft_s"] is not None
    assert _families(reg) == _families(jreg)
    # the ledger and the scheduler's flight-recorder view
    memz = tobs.memz_snapshot()
    mine = memz["providers"][f"serving_session_{id(sess):x}"]["components"]
    assert mine["kv_pool"] == sess._kv_pool_bytes > 0
    assert mine["weights"] == sum(t.numel() * t.element_size()
                                  for t in tm.state_dict().values())
    snap = sess.scheduler.snapshot()
    assert snap["knobs"]["num_blocks"] == sess._num_blocks
    assert snap["waiting"] == [] and snap["running"] == []


def test_request_spans_tile_lifetime(flags):
    """Shadows tests/test_tracing.py:171 without speculation: each
    request's span tree starts queue_wait, admit, then decode spans, its
    phases tile the request_done wall time, and the full-hit request's
    admit span records the CoW."""
    flags(observability=1, trace_sample_rate=1.0)
    _, tm = make_cb_pair("gpt", seed=6)
    _, log = _fresh(tobs)
    tracer = tobs.get_tracer()
    _drive(tm, tserving)
    done = {d["req_id"]: d for d in log.events("serving.request_done")}
    for rid in ("prime", "a", "b", "c"):
        tr = tracer.get(rid)
        assert tr is not None and tr.done
        assert done[rid]["trace_id"] == tr.trace_id
        tops = [s["name"] for s in tr.spans() if s["parent"] == 0]
        assert tops[:2] == ["queue_wait", "admit"] and "decode" in tops
        ph = done[rid]["phases"]
        assert ph == tobs.phase_breakdown(tr)
        total = done[rid]["total_s"]
        assert total * 0.5 <= sum(ph.values()) <= total * 1.02, (ph, total)
        if rid == "a":
            admit = next(s for s in tr.spans() if s["name"] == "admit")
            assert admit["args"]["cow"] is True
            assert admit["args"]["prefix_hit_tokens"] == 7
    doc = tracer.export_chrome()
    lanes = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M"}
    assert {"request prime", "request a", "request b"} <= lanes


def test_flag_off_records_nothing_and_streams_equal(flags):
    """Shadows tests/test_observability.py:288's flag-off arm: with
    observability off the port records no metric, event or trace, and
    serves the same tokens; stats survive."""
    _, tm = make_cb_pair("gpt", seed=11)
    flags(observability=1, trace_sample_rate=1.0)
    _fresh(tobs)
    on, sess_on = _drive(tm, tserving)
    flags(observability=0)
    reg, log = _fresh(tobs)
    off, sess_off = _drive(tm, tserving)
    for rid in on:
        np.testing.assert_array_equal(on[rid], off[rid], err_msg=rid)
    assert reg.get("serving_ttft_seconds") is None
    assert len(log) == 0 and not tobs.get_tracer().traces()
    assert sess_off.stats == sess_on.stats
    assert sess_off.stats["tokens_out"] == 21
