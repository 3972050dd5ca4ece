"""The port's Adam / AdamW against the JAX package's: fp32 masters, bf16
moments, master-weight-free bf16, stochastic rounding, state dicts and
the resume of a JAX optimizer's state (bridge.load_jax_optimizer_state).
The LR schedulers and gradient clipping are in test_torch_lr_clip.py.

Shadows tests/test_nn_optimizer.py (test_optimizer_state_dict_roundtrip,
the fused-optimizer tests) and tests/test_bf16_optimizer.py. Inputs are
numpy arrays from a seed; both packages get the same parameters and the
same gradients (set as ``p.grad``, so the optimizers alone are held).

Tolerances. Adam / AdamW: fp32 parameters and fp32 masters within 1e-6
relative and 1e-6 absolute, 1e-4 of the step size lr = 1e-2 (the same
fp32 operations, but XLA may contract a product and a sum into one
rounding, and Adam divides each gradient by its own running RMS, which
turns a last-bit difference of a near-zero gradient into up to 1e-4 of a
step: one element of 262,656 moved 6.8e-7 apart in the probe); bf16
parameters (rounded to nearest from those fp32 values) within one bf16
ulp, and at least 99% of them equal. bf16 moments: within one bf16 ulp.
Stochastic rounding draws other bits than the JAX package (Philox
against threefry), so it is held by its properties (unbiased, exact on
representable values, equal bytes under the same seed), as
test_bf16_optimizer.py holds it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.tensor import Parameter as JParameter
import paddle_tpu_torch as ptt
from paddle_tpu_torch.bridge import load_jax_optimizer_state
from paddle_tpu_torch.optimizer.optimizer import stochastic_round_bf16

# ---------------------------------------------------------------------------
# Adam and AdamW
# ---------------------------------------------------------------------------

# w_big is above the multi-tensor path's 2^18 elements, the rest below
SHAPES = {"w_big": (512, 513), "w": (64, 32), "b": (32,), "ln": (32,)}


def _init(seed=0, names=tuple(SHAPES)):
    rs = np.random.RandomState(seed)
    return {n: (rs.randn(*s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items() if n in names}


def _step_grads(step):
    rs = np.random.RandomState(100 + step)
    return {n: (rs.randn(*s) * 0.02).astype(np.float32)
            for n, s in SHAPES.items()}


def _jax_params(values, dtype):
    out = []
    for n, v in values.items():
        p = JParameter(jnp.asarray(v, getattr(jnp, dtype)))
        p.name = f"jax_{n}"
        out.append(p)
    return out


def _port_params(values, dtype):
    out = []
    for n, v in values.items():
        p = torch.nn.Parameter(torch.tensor(v).to(getattr(torch, dtype)))
        p.param_name = n
        out.append(p)
    return out


def _values(ps):
    """{structured name: fp32 numpy} of JAX or port parameters."""
    if isinstance(ps[0], torch.Tensor):
        return {p.param_name: p.detach().float().numpy() for p in ps}
    return {p.name[4:]: np.asarray(p._value.astype(jnp.float32))
            for p in ps}


def _set_grads(ps, grads):
    for p in ps:
        if isinstance(p, torch.Tensor):
            p.grad = torch.tensor(grads[p.param_name]).to(p.dtype)
        else:
            p.grad = paddle.to_tensor(jnp.asarray(grads[p.name[4:]],
                                                  p._value.dtype))


# name -> (optimizer class, kwargs, parameter dtype, masters, the
# recipe's clip and LR schedule); amsgrad takes the per-tensor path under
# use_multi_tensor too. The per-tensor cases run on two small tensors
# only: the JAX package compiles their update op by op for each shape
OPTS = {
    "adam_l2_amsgrad": ("Adam", dict(weight_decay=0.01, amsgrad=True,
                                     use_multi_tensor=True),
                        "float32", None, False),
    "adamw_fp32_masters_recipe": (
        "AdamW", dict(use_multi_tensor=True), "bfloat16", True, True),
    "adamw_bf16_moments": (
        "AdamW", dict(moment_dtype="bfloat16", lr_ratio=lambda p: 0.5,
                      apply_decay_param_fun=lambda n: not n.endswith("b")),
        "float32", None, False),
    "adamw_no_masters_sr_off": (
        "AdamW", dict(moment_dtype="bfloat16", use_multi_tensor=True),
        "bfloat16", False, True),
}


def _build(pkg, case, params):
    cls, kw, _dtype, masters, recipe = OPTS[case]
    lr = 1e-2
    extra = {}
    if recipe:
        lr = pkg.optimizer.lr.LinearWarmup(
            pkg.optimizer.lr.CosineAnnealingDecay(1e-2, T_max=3),
            warmup_steps=2, start_lr=1e-3, end_lr=1e-2)
        extra["grad_clip"] = pkg.nn.ClipGradByGlobalNorm(1.0)
    opt = getattr(pkg.optimizer, cls)(learning_rate=lr, parameters=params,
                                      **kw, **extra)
    if masters is not None:
        opt._multi_precision = masters    # as decorate(master_weight=...)
    return opt


def _run(pkg, opt, params, steps):
    for i in steps:
        _set_grads(params, _step_grads(i))
        opt.step()
        opt.clear_grad()
        if opt._lr_scheduler is not None:
            opt._lr_scheduler.step()


def _assert_params_close(got, want, dtype):
    for n in want:
        g, w = got[n], want[n]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                       err_msg=n)
        else:
            np.testing.assert_allclose(g, w, rtol=2.0 ** -8, atol=0,
                                       err_msg=n)
            assert np.mean(g == w) >= 0.99, n


@pytest.mark.parametrize("case", sorted(OPTS))
def test_adam_matches_jax_and_resumes_from_its_state(case):
    """Two steps of each optimizer from the same parameters and gradients
    give the JAX package's parameters and moments; a fresh port optimizer
    loaded with the JAX optimizer's state_dict (bridge) takes the third
    step as the JAX one does."""
    dtype = OPTS[case][2]
    per_tensor = not OPTS[case][1].get("use_multi_tensor") or "amsgrad" in case
    values = _init(names=("w", "b") if per_tensor else SHAPES)
    jps, tps = _jax_params(values, dtype), _port_params(values, dtype)
    jopt, topt = _build(paddle, case, jps), _build(ptt, case, tps)
    _run(paddle, jopt, jps, range(2))
    _run(ptt, topt, tps, range(2))
    _assert_params_close(_values(tps), _values(jps), dtype)
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    for p in jps:
        for acc in ("moment1", "moment2"):
            want = np.asarray(jsd[f"{p.name}_{acc}"]._value.astype(
                jnp.float32))
            got = tsd[f"{p.name[4:]}_{acc}"].float().numpy()
            np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                                       atol=1e-6 * np.abs(want).max())
    resumed = _port_params(_values(jps), dtype)
    ropt = _build(ptt, case, resumed)
    load_jax_optimizer_state(ropt, jsd, {p.name: p.name[4:] for p in jps})
    _run(paddle, jopt, jps, [2])
    _run(ptt, ropt, resumed, [2])
    _assert_params_close(_values(resumed), _values(jps), dtype)
    assert ropt._step_count == 3


def test_load_jax_optimizer_state_names_must_match():
    """A JAX entry naming no parameter of the port optimizer, or a port
    parameter with no entries, raises KeyError (as load_jax_state)."""
    values = _init()
    jps, tps = (_jax_params(values, "float32"),
                _port_params(values, "float32"))
    jopt = paddle.optimizer.Adam(learning_rate=1e-2, parameters=jps)
    _run(paddle, jopt, jps, [0])
    sd = jopt.state_dict()
    names = {p.name: p.name[4:] for p in jps}
    with pytest.raises(KeyError):
        load_jax_optimizer_state(
            ptt.optimizer.Adam(parameters=tps[:-1]), sd, names)
    with pytest.raises(KeyError):
        load_jax_optimizer_state(
            ptt.optimizer.Adam(parameters=tps),
            {k: v for k, v in sd.items() if "jax_ln_" not in k}, names)
    opt = ptt.optimizer.Adam(parameters=tps)
    load_jax_optimizer_state(opt, {"global_step": 4}, names)
    assert opt._step_count == 4


@pytest.mark.parametrize("multi_tensor", [True, False])
def test_moment_dtypes_per_key_match_jax(multi_tensor):
    """AdamW(moment_dtype="bfloat16"): under use_multi_tensor the tensors
    of at most 2^18 elements keep fp32 moments and the larger ones store
    bf16, per tensor every moment is bf16; the beta powers are fp32
    scalars; the state dict has the JAX package's keys (renamed),
    dtypes and shapes, and round-trips into a fresh optimizer."""
    values = _init()
    jps, tps = (_jax_params(values, "float32"),
                _port_params(values, "float32"))
    kw = dict(learning_rate=1e-2, moment_dtype="bfloat16",
              use_multi_tensor=multi_tensor)
    jopt = paddle.optimizer.AdamW(parameters=jps, **kw)
    topt = ptt.optimizer.AdamW(parameters=tps, **kw)
    _run(paddle, jopt, jps, [0])
    _run(ptt, topt, tps, [0])
    jsd, tsd = jopt.state_dict(), topt.state_dict()
    want = {}
    for k, v in jsd.items():
        if k != "global_step":
            want[k[4:]] = (str(v._value.dtype), tuple(v.shape))
    got = {k: (str(v.dtype).replace("torch.", ""), tuple(v.shape))
           for k, v in tsd.items() if k != "global_step"}
    assert got == want
    for n, (dt, _) in got.items():
        if n.endswith(("moment1", "moment2")):
            big = np.prod(SHAPES[n.rsplit("_", 1)[0]]) > 2 ** 18
            assert dt == ("bfloat16" if big or not multi_tensor
                          else "float32"), n
    assert int(tsd["global_step"]) == 1
    again = ptt.optimizer.AdamW(parameters=_port_params(values, "float32"),
                                **kw)
    again.set_state_dict(tsd)
    again.materialize_state()
    assert not again._pending_state
    assert {k: (v.dtype, tuple(v.shape)) for k, v in
            again.state_dict().items()} == {
        k: (v.dtype, tuple(v.shape)) for k, v in tsd.items()}


def test_moment_dtype_typo_and_unported_options_raise():
    """A moment_dtype typo raises ValueError at construction (it would
    silently store fp32), as in the JAX package; decorate(master_grad=)
    and string regularizers are not ported and raise."""
    p = torch.nn.Parameter(torch.zeros(3))
    with pytest.raises(ValueError, match="moment_dtype"):
        ptt.optimizer.AdamW(parameters=[p], moment_dtype="bf16")
    with pytest.raises(NotImplementedError, match="master_grad"):
        ptt.amp.decorate(torch.nn.Linear(2, 2), level="O2",
                         master_grad=True)
    with pytest.raises(NotImplementedError, match="regularizer"):
        ptt.optimizer.Adam(parameters=[p], weight_decay="L2")


# ---------------------------------------------------------------------------
# stochastic rounding and master-weight-free bf16
# ---------------------------------------------------------------------------

def test_stochastic_round_is_unbiased_and_exact_on_representable():
    """Shadows test_bf16_optimizer.py's: a value 1/8 of an ulp above 1.0
    rounds to 1.0 or the next bf16 value with a mean near the value;
    representable values never move; inf and NaN stay; the same
    generator state gives the same bytes."""
    x = torch.full((2048,), 1.0 + 2.0 ** -10)
    g = torch.Generator().manual_seed(0)
    acc = torch.zeros(2048, dtype=torch.float64)
    n = 64
    for _ in range(n):
        r = stochastic_round_bf16(x, g)
        assert r.dtype == torch.bfloat16
        assert set(r.float().unique().tolist()) <= {1.0, 1.0078125}
        acc += r.double()
    assert abs(float(acc.mean()) / n - (1.0 + 2.0 ** -10)) < 2e-4
    y = torch.tensor([0.5, -2.0, 0.0, 3.140625, float("inf"),
                      -float("inf")])
    assert torch.equal(stochastic_round_bf16(y, g).float(), y)
    assert torch.isnan(stochastic_round_bf16(torch.tensor([float("nan")]),
                                             g)).all()
    z = torch.randn(4096, generator=torch.Generator().manual_seed(1))
    a = stochastic_round_bf16(z, torch.Generator().manual_seed(5))
    b = stochastic_round_bf16(z, torch.Generator().manual_seed(5))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _decay_run(sr, steps):
    w = torch.nn.Parameter(torch.ones(64, 64, dtype=torch.bfloat16))
    w.param_name = "w"
    opt = ptt.optimizer.AdamW(parameters=[w], learning_rate=1e-2,
                              weight_decay=0.1, moment_dtype="bfloat16",
                              stochastic_rounding=sr)
    for _ in range(steps):
        w.grad = torch.zeros_like(w)     # zero gradients: pure decay
        opt.step()
        opt.clear_grad()
    return w


def test_pure_bf16_adamw_with_sr_decays_weights():
    """Shadows test_bf16_optimizer.py's: without masters each step's decay
    is below a bf16 ulp, so round-to-nearest freezes the weights at 1.0;
    the decay folded into the rounded value plus stochastic rounding
    decays them in expectation; two runs give the same bytes."""
    w = _decay_run(True, 200)
    expect = (1.0 - 1e-2 * 0.1) ** 200
    assert abs(float(w.float().mean()) - expect) < 0.03
    assert torch.equal(w, _decay_run(True, 200))
    assert float(_decay_run(False, 20).float().mean()) == 1.0


def test_recipe_step_keeps_bf16_state_and_no_masters():
    """bench.py's plan through decorate(master_weight=False): bf16
    parameters updated in place with stochastic rounding, bf16 moments
    on the large tensor, fp32 on the small ones, no fp32 master, and the
    same bytes from the same start."""
    def run():
        net = torch.nn.Sequential(ptt.nn.Linear(512, 513, device="cpu"),
                                  ptt.nn.Linear(513, 4, device="cpu"))
        ptt.nn.layer.common.name_parameters(net)
        with torch.no_grad():
            for p, v in zip(net.parameters(), _init(2).values()):
                p.copy_(torch.tensor(np.resize(v, p.shape)))
        opt = ptt.optimizer.AdamW(parameters=net.parameters(),
                                  learning_rate=1e-3, use_multi_tensor=True,
                                  moment_dtype="bfloat16",
                                  stochastic_rounding=True)
        net, opt = ptt.amp.decorate(models=net, optimizers=opt, level="O2",
                                    master_weight=False)
        x = torch.tensor(np.random.RandomState(4).randn(8, 512),
                         dtype=torch.float32)
        for _ in range(3):
            with ptt.amp.auto_cast(level="O2"):
                loss = net(x).float().square().mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
        return net, opt

    net, opt = run()
    assert not opt._master_weights
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    sd = opt.state_dict()
    assert sd["0.weight_moment1"].dtype == torch.bfloat16
    assert sd["0.bias_moment2"].dtype == torch.float32
    assert sd["1.weight_moment1"].dtype == torch.float32
    again, _ = run()
    for a, b in zip(net.parameters(), again.parameters()):
        assert torch.equal(a, b)


def _counting_adam(opt):
    """Wrap ``opt._adam`` to record the parameter count of each update,
    with the multi-tensor threshold cut to 1000 elements (so that small
    layers have big tensors)."""
    sizes, inner = [], opt._adam
    opt._FUSE_MAX_NUMEL = 1000

    def adam(params_grads, lr):
        sizes.append(len(params_grads))
        return inner(params_grads, lr)

    opt._adam = adam
    return sizes


def _net(*widths):
    return torch.nn.Sequential(*[
        ptt.nn.Linear(a, b, device="cpu")
        for a, b in zip(widths[:-1], widths[1:])])


@pytest.mark.parametrize("plan", ["masters_multi_tensor", "fp32_per_tensor"])
def test_fp32_state_updates_in_one_pass(plan):
    """Every parameter whose state is fp32 in place (fp32 moments, and a
    master or a fp32 parameter) is updated by one ``_foreach`` pass, big
    and small alike: [train]'s plan launches one set of passes a step."""
    net = _net(64, 65, 4)
    multi = plan == "masters_multi_tensor"
    opt = ptt.optimizer.AdamW(parameters=net.parameters(),
                              learning_rate=1e-3, use_multi_tensor=multi,
                              multi_precision=multi)
    if multi:
        net, opt = ptt.amp.decorate(models=net, optimizers=opt, level="O2")
    sizes = _counting_adam(opt)
    for p in net.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert sizes == [4]


def _grouped_run(group_numel):
    """Three SR steps of bf16 parameters without masters, bf16 moments on
    the big ones, updated ``group_numel`` elements at a time."""
    torch.manual_seed(0)
    net = _net(64, 65, 66, 4)
    ptt.nn.layer.common.name_parameters(net)
    opt = ptt.optimizer.AdamW(parameters=net.parameters(),
                              learning_rate=1e-3, use_multi_tensor=True,
                              moment_dtype="bfloat16",
                              stochastic_rounding=True)
    net, opt = ptt.amp.decorate(models=net, optimizers=opt, level="O2",
                                master_weight=False)
    opt._GROUP_NUMEL = group_numel
    sizes = _counting_adam(opt)
    rs = np.random.RandomState(5)
    for _ in range(3):
        for p in net.parameters():
            p.grad = torch.tensor(rs.randn(*p.shape),
                                  dtype=torch.float32).to(p.dtype)
        opt.step()
        opt.clear_grad()
    return net, opt, sizes


def test_grouped_update_gives_the_bytes_of_one_pass():
    """Parameters needing fp32 temporaries go in groups of at most
    ``_GROUP_NUMEL`` elements (a bigger one alone); the grouping changes
    no byte of the parameters or the state (equal bytes, tolerance 0)."""
    net1, opt1, sizes1 = _grouped_run(1 << 26)
    net2, opt2, sizes2 = _grouped_run(5000)
    net3, _, sizes3 = _grouped_run(1)
    assert sizes1 == [6] * 3
    assert sizes2 == [2, 4] * 3
    assert sizes3 == [1] * 18
    assert opt1.state_dict()["0.weight_moment1"].dtype == torch.bfloat16
    for a, b, c in zip(net1.parameters(), net2.parameters(),
                       net3.parameters()):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b) and torch.equal(a, c)
    sd1, sd2 = opt1.state_dict(), opt2.state_dict()
    assert sorted(sd1) == sorted(sd2)
    for k in sd1:
        if isinstance(sd1[k], torch.Tensor):
            assert torch.equal(sd1[k], sd2[k]), k
