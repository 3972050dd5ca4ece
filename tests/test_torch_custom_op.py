"""The port's custom-op extension API against the JAX package.

Shadows tests/test_custom_op.py (``ops.register_op``,
``utils.cpp_extension.load``) and tests/test_autograd.py's
``test_pylayer_custom``; each test names the test it shadows. The same
inputs, made with numpy from a seed, go through both packages.
K9 (``csrc/scale.cu``) runs only on a card, where chip_smoke.py and
tests/test_torch_card_checks.py hold it bit for bit against its plain
version ``scale_plain``; here ``scale_plain`` (what a CPU tensor runs) is
held bit for bit against the Pallas ``scale_kernel`` in interpret mode.

Not shadowed, and where each goes:
- the ``to_static`` halves of ``test_register_op_eager_jit_grad`` and
  ``test_cpp_extension_load``: they come with jit (ROADMAP queue A
  item 9);
- ``test_define_op_registers_and_generates_tests``: with the op suite
  (item 7);
- ``test_register_op_sharding_rule``: with the distributed API (item
  10); the port's ``out_sharding=`` raises until then (held below).
"""
import functools
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops as jops
import paddle_tpu_torch as ptt
from paddle_tpu_torch import ops as tops
from paddle_tpu_torch.bridge import load_jax_state
from paddle_tpu_torch.testing import custom_scale

FACTORS = [2.0, 0.1, 1 / 3]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

CPP_SOURCE = r"""
#include <cstdint>
#include <cmath>
extern "C" void softclip(const float* in, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = std::tanh(in[i]);
}
extern "C" void plus_one(const float* in, float* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] + 1.0f;
}
"""


@pytest.fixture
def cleanup():
    """Names registered in both packages by the test; deregistered in
    both afterwards."""
    names = []
    yield names
    for n in names:
        jops.deregister_op(n)
        tops.deregister_op(n)


def _np(t):
    """A tensor of either package as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    if isinstance(t, jax.Array):
        return np.asarray(t.astype(jnp.float32))
    return np.asarray(t.numpy()).astype(np.float32)


def test_register_op_eager_jit_grad(cleanup):
    """Shadows test_custom_op.py::test_register_op_eager_jit_grad, eager
    part: a cube op with a custom VJP gives equal outputs and gradients
    in both packages (exact: the same fp32 products in the same order),
    and the user's bwd, not autodiff, runs once in each."""
    calls = {"jax": 0, "torch": 0}

    def pair(pkg):
        def cube(x):
            return x * x * x

        def cube_fwd(x):
            return cube(x), x

        def cube_bwd(x, g):
            calls[pkg] += 1
            return (3.0 * x * x * g,)

        return cube, (cube_fwd, cube_bwd)

    jcube, jvjp = pair("jax")
    tcube, tvjp = pair("torch")
    jop = jops.register_op("test_cube", jcube, vjp=jvjp)
    top = tops.register_op("test_cube", tcube, vjp=tvjp)
    cleanup.append("test_cube")

    x_np = np.random.RandomState(0).randn(7).astype(np.float32)
    jx = paddle.to_tensor(x_np)
    jx.stop_gradient = False
    tx = ptt.to_tensor(x_np, place="cpu", stop_gradient=False)
    jout, tout = jop(jx), top(tx)
    np.testing.assert_array_equal(_np(tout), _np(jout))
    jout.sum().backward()
    tout.sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    assert calls == {"jax": 1, "torch": 1}
    # without a gradient to record, the impl runs and bwd does not
    with torch.no_grad():
        np.testing.assert_array_equal(_np(top(tx)), _np(jout))
    assert calls["torch"] == 1


def test_register_op_vjp_takes_nested_inputs_and_two_outputs(cleanup):
    """The custom-VJP convention beyond one tensor in, one out, in both
    packages: a positional input that is a list of tensors gets a list
    of cotangents, a non-tensor input None, and with two outputs bwd
    receives a tuple of their gradients. Outputs exact (the same fp32
    products in the same order); gradients within one fp32 ulp (2^-23
    relative: the JAX package's compiled backward may fuse bwd's
    multiply-add into one FMA). In the port a keyword argument is a static
    attribute bound to fwd (in the JAX package custom_vjp makes it one
    more primal input, so it is held in the port only)."""

    def impl(xs, k, scale=1.0):
        a, b = xs
        return a * b * (k * scale), a + b

    def fwd(xs, k, scale=1.0):
        return impl(xs, k, scale), (xs[0], xs[1], k * scale)

    def bwd(res, g):
        a, b, c = res
        g_prod, g_sum = g
        return [g_prod * b * c + g_sum, g_prod * a * c + g_sum], None

    jop = jops.register_op(
        "test_nested_vjp", lambda xs, k: impl(xs, k),
        vjp=(lambda xs, k: fwd(xs, k), bwd))
    top = tops.register_op("test_nested_vjp", impl, vjp=(fwd, bwd))
    cleanup.append("test_nested_vjp")
    rs = np.random.RandomState(2)
    a_np, b_np = (rs.randn(5).astype(np.float32) for _ in range(2))

    ja, jb = paddle.to_tensor(a_np), paddle.to_tensor(b_np)
    ja.stop_gradient = jb.stop_gradient = False
    jprod, jsum = jop([ja, jb], 3.0)
    (jprod.sum() + (jsum * jsum).sum()).backward()

    ta, tb = (ptt.to_tensor(v, place="cpu", stop_gradient=False)
              for v in (a_np, b_np))
    tprod, tsum = top([ta, tb], 3.0)
    (tprod.sum() + (tsum * tsum).sum()).backward()
    for t, j in ((tprod, jprod), (tsum, jsum)):
        np.testing.assert_array_equal(_np(t), _np(j))
    for t, j in ((ta.grad, ja.grad), (tb.grad, jb.grad)):
        np.testing.assert_allclose(_np(t), _np(j), rtol=2.0 ** -23, atol=0)
    ta.grad = None
    top([ta, tb], 3.0, scale=2.0)[0].sum().backward()
    np.testing.assert_array_equal(_np(ta.grad), b_np * np.float32(6.0))


def _gelu_like_jax(x):
    return x * 0.5 * (1.0 + jnp.tanh(0.79788456 * (x + 0.044715 * x ** 3)))


def _gelu_like_torch(x):
    return x * 0.5 * (1.0 + torch.tanh(0.79788456 * (x + 0.044715 * x ** 3)))


def test_register_op_trains_through_model(cleanup):
    """Shadows test_custom_op.py::test_register_op_trains_through_model:
    the same Linear(4, 1) (weights bridged from the JAX layer), a
    registered op without a VJP (autodiff through its impl) and 10 SGD
    steps at lr 0.1. The losses agree to 1e-6 relative (the two packages
    sum the mean and the matmul in other orders) and fall."""
    jact = jops.register_op("test_gelu_like", _gelu_like_jax)
    tact = tops.register_op("test_gelu_like", _gelu_like_torch)
    cleanup.append("test_gelu_like")

    paddle.seed(0)
    jlin = paddle.nn.Linear(4, 1)
    tlin = ptt.nn.Linear(4, 1, device="cpu")
    load_jax_state(tlin, {k: np.asarray(v._value)
                          for k, v in jlin.state_dict().items()})
    jopt = paddle.optimizer.SGD(learning_rate=0.1,
                                parameters=jlin.parameters())
    topt = ptt.optimizer.SGD(learning_rate=0.1,
                             parameters=tlin.parameters())
    x_np = np.random.RandomState(0).randn(16, 4).astype("float32")
    y_np = np.random.RandomState(1).randn(16, 1).astype("float32")
    jX, jy = paddle.to_tensor(x_np), paddle.to_tensor(y_np)
    tX, ty = (ptt.to_tensor(a, place="cpu") for a in (x_np, y_np))

    jl, tl = [], []
    for _ in range(10):
        loss = ((jact(jlin(jX)) - jy) ** 2).mean()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        loss = ((tact(tlin(tX)) - ty) ** 2).mean()
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(float(loss.detach()))
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]


def _jax_scale_impl(factor):
    """The reference test's `scale_kernel` / `scale_impl`
    (test_custom_op.py:101-109) with the factor as a parameter."""
    from jax.experimental import pallas as pl

    def scale_kernel(x_ref, o_ref, *, factor):
        o_ref[...] = x_ref[...] * factor

    def scale_impl(x):
        return pl.pallas_call(
            functools.partial(scale_kernel, factor=factor),
            out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
            interpret=True,
        )(x)

    return scale_impl


@pytest.mark.parametrize("factor", FACTORS, ids=["2", "0.1", "1/3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_register_pallas_op(cleanup, dtype, factor):
    """Shadows test_custom_op.py::test_register_pallas_op: the JAX side
    registers the Pallas `scale_kernel` (interpret mode) with the VJP
    g * factor; the port registers K9's `scale` with `scale_vjp`, which
    on a CPU tensor runs the plain version. Outputs and gradients are
    equal bit for bit (exact: both round the factor to x's dtype, form
    the product in fp32 and round once), at 2.0 as in the reference test
    and at two factors that round in bf16."""
    jdt, tdt = DTYPES[dtype]
    impl = _jax_scale_impl(factor)
    jop = jops.register_op(
        "test_pallas_scale", impl,
        vjp=(lambda x: (impl(x), None), lambda _, g: (g * factor,)))
    top = tops.register_op("test_pallas_scale", custom_scale.scale,
                           vjp=custom_scale.scale_vjp)
    cleanup.append("test_pallas_scale")

    x_np = np.random.RandomState(5).randn(2, 4, 96).astype(np.float32)
    jx = paddle.to_tensor(x_np, dtype=dtype)
    jx.stop_gradient = False
    tx = torch.tensor(x_np).to(tdt).requires_grad_()
    kernel = custom_scale.SCALE_KERNEL
    kernel.reset_counts()
    jout, tout = jop(jx), top(tx, factor=factor)
    assert tout.dtype == tdt
    np.testing.assert_array_equal(_np(tout), _np(jout))
    jout.sum().backward()
    tout.sum().backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    # the CPU path: the plain version forward and backward, no launch
    assert (kernel.launches, kernel.plain_calls) == (0, 2)


@pytest.mark.parametrize("shape", [(2, 4), (1,), (4097,), (3, 5, 7)])
@pytest.mark.parametrize("factor", FACTORS, ids=["2", "0.1", "1/3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_plain_matches_pallas_kernel_interpret(dtype, factor, shape):
    """K9's plain version against the Pallas `scale_kernel` in interpret
    mode, bit for bit, at chip_smoke's small shapes (the reference's
    [2, 4], n = 1, n = 4097 with a vector tail). A transposed input gives
    the plain product of the transposed values."""
    jdt, tdt = DTYPES[dtype]
    x_np = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    want = _jax_scale_impl(factor)(jnp.asarray(x_np, jdt))
    got = custom_scale.scale_plain(torch.tensor(x_np).to(tdt), factor)
    assert got.dtype == tdt and got.shape == torch.Size(shape)
    np.testing.assert_array_equal(_np(got), _np(want))
    if len(shape) > 1:
        xt = torch.tensor(x_np).to(tdt).transpose(0, -1)
        np.testing.assert_array_equal(
            _np(custom_scale.scale_plain(xt, factor)),
            _np(want).transpose(*reversed(range(len(shape)))))


def test_scale_torch_mul_differs_where_the_factor_rounds():
    """Why K9 rounds the factor first: torch's bf16 `x * 0.1` keeps the
    factor in fp32 and differs from the Pallas kernel; the plain version
    does not."""
    x_np = np.random.RandomState(9).randn(4096).astype(np.float32)
    want = _np(_jax_scale_impl(0.1)(jnp.asarray(x_np, jnp.bfloat16)))
    x = torch.tensor(x_np).bfloat16()
    assert (_np(x * 0.1) != want).any()
    np.testing.assert_array_equal(_np(custom_scale.scale_plain(x, 0.1)),
                                  want)


def _chunk(dtype):
    """Elements of one CTA's chunk in csrc/scale.cu: SCALE_VECS_IN_FLIGHT
    16-byte vectors for each of SCALE_THREADS threads."""
    itemsize = torch.empty((), dtype=DTYPES[dtype][1]).element_size()
    return (custom_scale.SCALE_VECS_IN_FLIGHT * custom_scale.SCALE_THREADS
            * 16 // itemsize)


@pytest.mark.parametrize("edge", [-1, 0, 1], ids=["chunk-1", "chunk",
                                                  "chunk+1"])
@pytest.mark.parametrize("factor", FACTORS, ids=["2", "0.1", "1/3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_plain_matches_pallas_kernel_around_the_chunk(dtype, factor,
                                                            edge):
    """K9's plain version against the Pallas `scale_kernel` in interpret
    mode, bit for bit, at one element either side of the kernel's chunk
    (2048 fp32 or 4096 bf16 elements: the last vector in flight of the
    first CTA is the chunk's last, and one more element leaves a scalar
    tail)."""
    jdt, tdt = DTYPES[dtype]
    n = _chunk(dtype) + edge
    x_np = np.random.RandomState(n).randn(n).astype(np.float32)
    want = _jax_scale_impl(factor)(jnp.asarray(x_np, jdt))
    got = custom_scale.scale_plain(torch.tensor(x_np).to(tdt), factor)
    assert got.dtype == tdt and got.shape == (n,)
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_geometry_matches_the_kernel_source(dtype):
    """custom_scale's copy of scale.cu's geometry is the source's, and
    `scale_split` cuts every length at every 16-byte offset into a head
    and a tail shorter than a vector around whole vectors."""
    src = (Path(custom_scale.__file__).parents[1] / "csrc"
           / "scale.cu").read_text()
    assert (f"constexpr int kThreads = {custom_scale.SCALE_THREADS};"
            in src)
    assert (f"constexpr int kVecsInFlight = "
            f"{custom_scale.SCALE_VECS_IN_FLIGHT};" in src)
    itemsize = torch.empty((), dtype=DTYPES[dtype][1]).element_size()
    v = 16 // itemsize
    for n in (1, 2, v - 1, v, v + 1, _chunk(dtype) - 1, _chunk(dtype) + 1):
        for off in range(0, 16, itemsize):
            head, nvec, tail = custom_scale.scale_split(n, off, itemsize)
            assert head + nvec * v + tail == n
            assert 0 <= head < v and 0 <= tail < v and nvec >= 0
            assert (off + head * itemsize) % 16 == 0 or head == n


def test_scale_wrapper_routes_by_device():
    """On a CPU tensor `scale` runs the plain version (empty included);
    `scale_cuda` refuses a CPU tensor, and the kernel takes fp32/bf16
    only (checked before any launch)."""
    kernel = custom_scale.SCALE_KERNEL
    kernel.reset_counts()
    assert custom_scale.scale(torch.empty(0, 3)).shape == (0, 3)
    assert (kernel.launches, kernel.plain_calls) == (0, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        custom_scale.scale_cuda(torch.ones(3))
    with pytest.raises(TypeError):
        custom_scale.scale_plain(torch.ones(3, dtype=torch.int32))


def test_duplicate_registration_rejected(cleanup):
    """Shadows test_custom_op.py::test_duplicate_registration_rejected;
    after deregister_op the name registers again and serves the new
    impl, in both packages."""
    for ops_, mk in ((jops, paddle.to_tensor),
                     (tops, lambda a: ptt.to_tensor(a, place="cpu"))):
        ops_.register_op("test_dup", lambda x: x)
        with pytest.raises(ValueError, match="already registered"):
            ops_.register_op("test_dup", lambda x: x)
        ops_.deregister_op("test_dup")
        again = ops_.register_op("test_dup", lambda x: x + 1)
        np.testing.assert_array_equal(
            _np(again(mk(np.zeros(2, np.float32)))), [1.0, 1.0])
    cleanup.append("test_dup")


def test_cpp_extension_load(tmp_path, cleanup):
    """Shadows test_custom_op.py::test_cpp_extension_load, eager part:
    both packages compile the same C++ source with g++ and register
    `plus_one` and `softclip` (with a VJP). plus_one is exact (the same
    C function); the C softclip is held to np.tanh within 1e-6, as the
    reference test holds it; with a gradient, both
    run the VJP's fwd (jnp.tanh / torch.tanh, which may differ in the
    last bits: 1e-6 relative) and the same bwd, 1 - t^2 of each
    package's own t (exact; across packages 1 - t^2 near |t| = 1 would
    magnify those last bits). A gradient through plus_one raises in both
    packages."""
    from paddle_tpu.utils import cpp_extension as jcpp
    from paddle_tpu_torch.utils import cpp_extension as tcpp

    src = tmp_path / "my_ops.cc"
    src.write_text(CPP_SOURCE)
    jfns = jcpp.load(
        "port_shadow_ext", [str(src)], functions=["softclip", "plus_one"],
        vjps={"softclip": (lambda x: (jnp.tanh(x),) * 2,
                           lambda t, g: ((1.0 - t * t) * g,))})
    tfns = tcpp.load(
        "port_shadow_ext", [str(src)], functions=["softclip", "plus_one"],
        vjps={"softclip": (lambda x: (torch.tanh(x),) * 2,
                           lambda t, g: ((1.0 - t * t) * g,))})
    cleanup.extend(["port_shadow_ext.softclip", "port_shadow_ext.plus_one"])
    assert tcpp.BUILD_ROOT in tcpp._build("port_shadow_ext",
                                          [str(src)]).parents

    x_np = np.random.RandomState(3).randn(64).astype(np.float32) * 2
    jy = jfns["plus_one"](paddle.to_tensor(x_np))
    ty = tfns["plus_one"](ptt.to_tensor(x_np, place="cpu"))
    assert ty.dtype == torch.float32
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(ty), x_np + 1.0)
    # no gradient to record: the C softclip
    np.testing.assert_allclose(
        _np(tfns["softclip"](ptt.to_tensor(x_np, place="cpu"))),
        np.tanh(x_np), rtol=1e-6)

    jz_in = paddle.to_tensor(x_np)
    jz_in.stop_gradient = False
    tz_in = ptt.to_tensor(x_np, place="cpu", stop_gradient=False)
    jz, tz = jfns["softclip"](jz_in), tfns["softclip"](tz_in)
    np.testing.assert_allclose(_np(tz), _np(jz), rtol=1e-6)
    jz.sum().backward()
    tz.sum().backward()
    # the same bwd in each: 1 - t^2 of the package's own fwd (the JAX
    # package's eager path returns impl's output and re-runs fwd for the
    # residual in the backward): bit for bit in the port, within one ulp
    # of 1.0 in the JAX package, whose compiled backward may contract
    # t * t into the subtraction
    np.testing.assert_array_equal(_np(tz_in.grad), 1 - _np(tz) ** 2)
    np.testing.assert_allclose(_np(jz_in.grad),
                               1 - np.asarray(jnp.tanh(x_np)) ** 2,
                               rtol=0, atol=2.0 ** -23)

    jp_in = paddle.to_tensor(x_np)
    jp_in.stop_gradient = False
    with pytest.raises(Exception):
        jfns["plus_one"](jp_in).sum().backward()
    tp_in = ptt.to_tensor(x_np, place="cpu", stop_gradient=False)
    with pytest.raises(RuntimeError, match="port_shadow_ext.plus_one"):
        tfns["plus_one"](tp_in).sum().backward()


def test_cpp_extension_reports_a_missing_symbol(tmp_path):
    from paddle_tpu_torch.utils import cpp_extension as tcpp

    src = tmp_path / "my_ops.cc"
    src.write_text(CPP_SOURCE)
    with pytest.raises(RuntimeError, match="extern"):
        tcpp.load("port_missing_ext", [str(src)], functions=["no_such_fn"])
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="build failed"):
        tcpp.load("port_bad_ext", [str(bad)], functions=["f"])


def test_pylayer_custom():
    """Shadows test_autograd.py::test_pylayer_custom: a PyLayer cube
    with its own backward gives x.grad = 3x^2 in both packages (exact),
    through ctx.saved_tensor() and the saved_tensors property."""

    def cube_layer(base):
        class Cube(base):
            @staticmethod
            def forward(ctx, x):
                ctx.save_for_backward(x)
                ctx.mark_not_inplace(x)
                return x * x * x

            @staticmethod
            def backward(ctx, dy):
                (x,) = ctx.saved_tensor()
                (x2,) = ctx.saved_tensors
                return dy * 3 * x * x2

        return Cube

    jx = paddle.to_tensor([2.0], stop_gradient=False)
    cube_layer(paddle.PyLayer).apply(jx).backward()
    tx = ptt.to_tensor([2.0], place="cpu", stop_gradient=False)
    out = cube_layer(ptt.PyLayer).apply(tx)
    assert type(out.grad_fn).__name__ == "CubeBackward"
    out.backward()
    np.testing.assert_array_equal(_np(tx.grad), _np(jx.grad))
    np.testing.assert_array_equal(_np(tx.grad), [12.0])


def _muladd_layer(base):
    class MulAdd(base):
        @staticmethod
        def forward(ctx, a, k, b):
            ctx.save_for_backward(a, b)
            ctx.k = k
            return a * b * k, a + b

        @staticmethod
        def backward(ctx, d_prod, d_sum):
            a, b = ctx.saved_tensors
            return d_prod * b * ctx.k + d_sum, d_prod * a * ctx.k + d_sum

    return MulAdd


def _kw_layer(base):
    class ScaleShift(base):
        @staticmethod
        def forward(ctx, x, k=1.0, w=None, b=None):
            ctx.save_for_backward(x, w)
            ctx.k = k
            return x * w * k + b

        @staticmethod
        def backward(ctx, dy):
            x, w = ctx.saved_tensor()
            # the positional tensor, then the keyword tensors in the
            # order they were passed (w, b)
            return dy * w * ctx.k, dy * x * ctx.k, dy

    return ScaleShift


def test_pylayer_non_tensor_inputs_and_two_outputs():
    """Gradients go to the tensor inputs only, in order; two outputs
    each bring their gradient to backward. Held against paddle.PyLayer on
    the same seeded inputs, exactly (the same fp32 products and sums)."""
    rng = np.random.default_rng(11)
    a_np, b_np = rng.standard_normal((2, 5), dtype=np.float32)
    grads = []
    for pkg, base, kw in ((paddle, paddle.PyLayer, {}),
                          (ptt, ptt.PyLayer, {"place": "cpu"})):
        a = pkg.to_tensor(a_np, stop_gradient=False, **kw)
        b = pkg.to_tensor(b_np, stop_gradient=False, **kw)
        prod, total = _muladd_layer(base).apply(a, 3.0, b)
        (prod + 10 * total).sum().backward()
        grads.append((_np(prod), _np(total), _np(a.grad), _np(b.grad)))
    for j, t in zip(*grads):
        np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(grads[1][2], b_np * 3 + 10)


@pytest.mark.parametrize("need", ["all", "keyword_only"])
def test_pylayer_keyword_tensor_inputs_get_gradients(need):
    """As paddle.PyLayer.apply (autograd/py_layer.py:55-57) counts
    tensors passed by keyword as tensor inputs, after the positional
    ones, so does the port: backward's gradients map to (x, w, b), a
    non-tensor keyword stays an attribute, and a keyword tensor gets its
    gradient when it is the only input that needs one. Held against the
    JAX package on the same seeded inputs, exactly."""
    rng = np.random.default_rng(12)
    x_np, w_np, b_np = rng.standard_normal((3, 4), dtype=np.float32)
    grads = []
    for pkg, base, kw in ((paddle, paddle.PyLayer, {}),
                          (ptt, ptt.PyLayer, {"place": "cpu"})):
        x = pkg.to_tensor(x_np, stop_gradient=need != "all", **kw)
        w = pkg.to_tensor(w_np, stop_gradient=False, **kw)
        b = pkg.to_tensor(b_np, stop_gradient=need != "all", **kw)
        out = _kw_layer(base).apply(x, k=0.5, w=w, b=b)
        (out * out).sum().backward()
        grads.append([_np(out), _np(w.grad)] + (
            [_np(x.grad), _np(b.grad)] if need == "all" else []))
    for j, t in zip(*grads):
        np.testing.assert_array_equal(t, j)


AMP_CASES = [("allow", "O1"), ("allow", "O2"), ("promote", "O1"),
             ("promote", "O2"), ("block", "O1")]


@pytest.mark.parametrize("policy,level", AMP_CASES)
def test_amp_policy_dtype_matches_jax(cleanup, policy, level):
    """The dtype a registered op's impl receives under auto_cast from
    fp32 inputs is the JAX package's at every policy and level where the
    reference follows its documented intent (`block` at O2: next
    test)."""
    seen = {}

    def record(pkg):
        def impl(x):
            seen[pkg] = str(x.dtype).split(".")[-1]
            return x
        return impl

    jop = jops.register_op("test_amp_policy", record("jax"), amp=policy)
    top = tops.register_op("test_amp_policy", record("torch"), amp=policy)
    cleanup.append("test_amp_policy")
    x_np = np.ones(4, np.float32)
    with paddle.amp.auto_cast(level=level):
        jop(paddle.to_tensor(x_np))
    with ptt.amp.auto_cast(level=level):
        top(ptt.to_tensor(x_np, place="cpu"))
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == ("bfloat16" if policy == "allow" or level == "O2"
                             else "float32")


def test_amp_block_forces_fp32_at_o2_where_the_jax_package_casts(cleanup):
    """Reference caveat (ROADMAP queue C item 5): `OpDef` documents
    amp="block" as "force fp32", but the JAX package's amp_cast_dtype
    reads only its lists, so a `block` op gets bf16 under O2. The port
    follows the documented intent: fp32. The JAX package's bf16 is
    recorded here so that a change on its side shows."""
    seen = {}

    def record(pkg):
        def impl(x):
            seen[pkg] = str(x.dtype).split(".")[-1]
            return x
        return impl

    jop = jops.register_op("test_amp_block", record("jax"), amp="block")
    top = tops.register_op("test_amp_block", record("torch"), amp="block")
    cleanup.append("test_amp_block")
    x_np = np.ones(4, np.float32)
    with paddle.amp.auto_cast(level="O2"):
        jop(paddle.to_tensor(x_np))
    with ptt.amp.auto_cast(level="O2"):
        top(ptt.to_tensor(x_np, place="cpu"))
    assert seen == {"jax": "bfloat16", "torch": "float32"}
    # a bf16 input is cast up, as a black-listed op's is
    with ptt.amp.auto_cast(level="O2"):
        top(torch.ones(4, dtype=torch.bfloat16))
    assert seen["torch"] == "float32"


@pytest.fixture
def nan_check_flags():
    """FLAGS_check_nan_inf on in both packages, restored in finally (a
    flag left set leaks into the next test file of the worker)."""
    from paddle_tpu.core.flags import get_flags as jget

    names = ("FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level")
    jprev = jget(list(names))
    tprev = {n: ptt.core.get_flag(n) for n in names}
    try:
        yield
    finally:
        paddle.set_flags(jprev)
        ptt.set_flags(tprev)


def test_check_nan_inf_raises_in_both_packages(cleanup, nan_check_flags):
    """Shadows the FLAGS_check_nan_inf contract of the JAX registry
    (registry.py:439): level 0 raises FloatingPointError naming the op,
    another level warns (the JAX package prints) and returns."""
    jop = jops.register_op("test_nan_op", jnp.log)
    top = tops.register_op("test_nan_op", torch.log)
    cleanup.append("test_nan_op")
    x_np = -np.ones(3, np.float32)
    tx = ptt.to_tensor(x_np, place="cpu")
    assert torch.isnan(top(tx)).all()        # flag off: no check
    flags = {"FLAGS_check_nan_inf": True, "FLAGS_check_nan_inf_level": 0}
    paddle.set_flags(flags)
    ptt.set_flags(flags)
    with pytest.raises(FloatingPointError, match="test_nan_op"):
        jop(paddle.to_tensor(x_np))
    with pytest.raises(FloatingPointError, match="test_nan_op"):
        top(tx)
    ptt.set_flags({"FLAGS_check_nan_inf_level": 1})
    assert ptt.core.get_flag("FLAGS_check_nan_inf_level") == 1
    with pytest.warns(RuntimeWarning, match="test_nan_op"):
        top(tx)
    # a finite output passes the check
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        top(ptt.to_tensor(np.ones(3, np.float32), place="cpu"))


def test_out_sharding_is_not_ported():
    """test_custom_op.py::test_register_op_sharding_rule is not shadowed
    (distributed, ROADMAP queue A item 10); the option raises, naming
    itself, and registers nothing."""
    with pytest.raises(NotImplementedError, match="out_sharding"):
        tops.register_op("test_sharded_id", lambda x: x,
                         out_sharding=lambda mesh, x: None)
    assert "test_sharded_id" not in tops.OPS


def test_apply_op_promotes_nests_and_spans(cleanup):
    """The dispatch pipeline's other steps: promote=True casts the tensor
    arguments to their common dtype (as the JAX package does), tensors in
    nested lists reach the impl, a list of outputs comes back as a tuple,
    and while a torch profiler records, each call is an "op:<name>" span
    on its trace."""
    jadd = jops.register_op("test_promote_add", lambda x, y: x + y,
                            promote=True)
    tadd = tops.register_op("test_promote_add", lambda x, y: x + y,
                            promote=True)
    tsplit = tops.register_op(
        "test_nested", lambda pair, k=1: [pair[0] * k, pair[1] + k])
    cleanup.extend(["test_promote_add", "test_nested"])
    a, b = np.ones(3, np.float32), np.arange(3, dtype=np.float32)
    jout = jadd(paddle.to_tensor(a, dtype="bfloat16"), paddle.to_tensor(b))
    tout = tadd(ptt.to_tensor(a, dtype="bfloat16", place="cpu"),
                ptt.to_tensor(b, place="cpu"))
    assert str(tout.dtype).split(".")[-1] == str(jout.dtype).split(".")[-1]
    np.testing.assert_array_equal(_np(tout), _np(jout))

    x = torch.ones(2)
    out = tsplit([x, 2 * x], k=3)
    assert isinstance(out, tuple) and len(out) == 2
    np.testing.assert_array_equal(_np(out[1]), [5.0, 5.0])
    assert tsplit.op_def is tops.OPS["test_nested"]

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tsplit([x, x])
    assert "op:test_nested" in {e.name for e in prof.events()}
    assert tops.raw(x) is x


def test_to_tensor_defaults_and_device():
    """paddle.to_tensor's Python-scalar defaults (bool, int64, float32),
    stop_gradient as requires_grad, and a copy on the given place. The
    JAX package agrees for bool and float; its int narrows to int32, as
    JAX does without x64."""
    cases = [(True, torch.bool), (3, torch.int64), (2.5, torch.float32),
             ([1.0, 2.0], torch.float32), ([1, 2], torch.int64)]
    for data, want in cases:
        assert ptt.to_tensor(data, place="cpu").dtype == want
    for data in (True, 2.5, [1.0, 2.0]):
        assert (str(paddle.to_tensor(data).dtype).split(".")[-1]
                == str(ptt.to_tensor(data, place="cpu").dtype).split(".")[-1])
    src = torch.ones(2)
    t = ptt.to_tensor(src, place=ptt.CPUPlace(), stop_gradient=False)
    assert t.requires_grad and t.data_ptr() != src.data_ptr()
    assert not ptt.to_tensor(src, place="cpu").requires_grad
    assert ptt.to_tensor(np.arange(3), dtype="float32",
                         place="cpu").dtype == torch.float32


def test_to_tensor_without_place_raises_when_no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptt.to_tensor([1.0])


def test_sgd_weight_decay_steps_match_jax():
    """Shadows the SGD update of paddle_tpu/optimizer/optimizers.py:14
    (its tests run through test_register_op_trains_through_model): 3 fp32
    steps with an L2 coefficient from the same weights and gradients
    give the same parameters within 1e-6 relative."""
    rs = np.random.RandomState(4)
    w_np = rs.randn(5, 3).astype(np.float32)
    g_nps = [rs.randn(5, 3).astype(np.float32) for _ in range(3)]

    jw = paddle.create_parameter([5, 3], "float32")
    jw.set_value(w_np)
    jopt = paddle.optimizer.SGD(learning_rate=0.05, parameters=[jw],
                                weight_decay=0.01)
    tw = torch.nn.Parameter(torch.tensor(w_np))
    topt = ptt.optimizer.SGD(learning_rate=0.05, parameters=[tw],
                             weight_decay=0.01)
    for g in g_nps:
        jw.grad = paddle.to_tensor(g)
        jopt.step()
        tw.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=1e-6, atol=1e-7)


def test_custom_op_ffn_trains_under_o2(cleanup):
    """chip_smoke.py's [custom_op] training recipe at a tiny width, port
    only: Linear -> a registered gelu-like op (no VJP) -> the K9 op at
    factor 0.5 -> Linear, SGD under amp.decorate(O2) and auto_cast. The
    K9 op runs in bf16 (its plain version here: one call forward and one
    backward a step), the masters stay fp32 and the loss falls."""
    act = tops.register_op("test_gelu_like", _gelu_like_torch)
    half = tops.register_op("test_k9_scale", custom_scale.scale,
                            vjp=custom_scale.scale_vjp)
    cleanup.extend(["test_gelu_like", "test_k9_scale"])
    gen = ptt.seed(0, "cpu")
    lin1 = ptt.nn.Linear(16, 64, device="cpu", generator=gen)
    lin2 = ptt.nn.Linear(64, 16, device="cpu", generator=gen)
    model = torch.nn.Sequential(lin1, lin2)
    opt = ptt.optimizer.SGD(learning_rate=0.5,
                            parameters=model.parameters())
    model, opt = ptt.amp.decorate(models=model, optimizers=opt, level="O2")
    rs = np.random.RandomState(0)
    x = ptt.to_tensor(rs.randn(32, 16).astype(np.float32), place="cpu")
    y = ptt.to_tensor(rs.randn(32, 16).astype(np.float32), place="cpu")
    kernel = custom_scale.SCALE_KERNEL
    kernel.reset_counts()
    losses = []
    for _ in range(10):
        with ptt.amp.auto_cast(level="O2"):
            h = half(act(lin1(x)), factor=0.5)
            assert h.dtype == torch.bfloat16
            loss = ((lin2(h).float() - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss.detach()))
    assert (kernel.launches, kernel.plain_calls) == (0, 20)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert lin1.weight.dtype == torch.bfloat16
    master = opt._master_weights[id(lin1.weight)]
    assert master.dtype == torch.float32
    assert torch.equal(master.to(torch.bfloat16), lin1.weight.detach())
