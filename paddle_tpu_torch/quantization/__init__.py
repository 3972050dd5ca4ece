"""Quantization: PTQ observers, QAT fake-quant, int8/int4 weight-only and
int8 execution. Counterpart of paddle_tpu/quantization/__init__.py.

Simulated quantization (quant-dequant in floating point) runs through the
op dispatch (``fake_quant``, an ``amp="block"`` op whose backward is the
straight-through estimator). The weight-only path stores REAL int8 (or
packed int4) weights and their f32 scales; a product dequantizes its
operand just before it (``dequantize_weight``: the int8 load times the
scale, then the model dtype), as the JAX package's traced code does
before XLA fuses it into the matmul. ``Int8ExecLinear`` contracts int8
activations with int8 weights into int32 (``torch._int_mm``).

The observers and wrappers walk ``named_children`` and swap with
``setattr``, where the JAX package walks its Layers' ``_sub_layers``. The
port has no Conv2D yet: only ``Linear`` is quantizable (Conv2D joins
when ROADMAP queue A item 7 ports it).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Type

import numpy as np
import torch

from ..core.numerics import ieee_div
from ..nn import Linear
from ..nn import functional as F
from ..ops.registry import OpDef, apply_op

__all__ = [
    "QuantConfig", "PTQ", "QAT", "AbsmaxObserver",
    "MovingAverageAbsmaxObserver", "FakeQuanterWithAbsMaxObserver",
    "quanters", "observers", "quantize_weight_only", "QuantedLinear",
    "Int8ExecLinear", "convert_to_int8_exec",
    "quantize_weight_tree", "dequantize_weight",
]


# ---------------------------------------------------------------------------
# fake quant op (straight-through estimator)
# ---------------------------------------------------------------------------

def _fake_quant_impl(x, scale, *, bits):
    qmax = 2.0 ** (bits - 1) - 1
    s = torch.clamp(scale, min=1e-9)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    return ieee_div(q * s, qmax)


class _FakeQuantSTE(torch.autograd.Function):
    """Quant-dequant forward; the backward passes the gradient of x
    through unchanged and gives the scale none."""

    @staticmethod
    def forward(ctx, x, scale, bits):
        return _fake_quant_impl(x, scale, bits=bits)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


_FQ_OP = OpDef("fake_quantize_dequantize",
               lambda x, scale, bits=8: _FakeQuantSTE.apply(x, scale, bits),
               amp="block")


def fake_quant(x, scale, bits: int = 8):
    """x quantized to ``bits`` on the grid of absmax ``scale`` and back,
    with a straight-through gradient. Under amp the op runs in fp32 (the
    port's ``block`` policy; the JAX package runs it in bf16 under O2,
    ROADMAP queue C item 5)."""
    sc = (scale if isinstance(scale, torch.Tensor)
          else torch.tensor(scale, dtype=torch.float32, device=x.device))
    return apply_op(_FQ_OP, x, sc, bits=bits)


# ---------------------------------------------------------------------------
# observers (observers/abs_max.py parity)
# ---------------------------------------------------------------------------

class BaseObserver(torch.nn.Module):
    def __init__(self, quant_bits=8):
        super().__init__()
        self.quant_bits = quant_bits
        self._scale = None

    def scale(self):
        return self._scale if self._scale is not None else 1.0

    def forward(self, x):
        self._observe(x)
        return x


def _absmax(x) -> float:
    """max |x| on the host (the observers' one read of the device)."""
    return float(x.detach().abs().max())


class AbsmaxObserverLayer(BaseObserver):
    """Running max(|x|) over calibration batches."""

    def _observe(self, x):
        m = _absmax(x)
        self._scale = m if self._scale is None else max(self._scale, m)


class MovingAverageAbsmaxObserverLayer(BaseObserver):
    def __init__(self, quant_bits=8, moving_rate=0.9):
        super().__init__(quant_bits)
        self._rate = moving_rate

    def _observe(self, x):
        m = _absmax(x)
        self._scale = (m if self._scale is None
                       else self._rate * self._scale + (1 - self._rate) * m)


class _Factory:
    """ObserverFactory/QuanterFactory parity: holds constructor args;
    each observed layer gets its own instance."""

    layer_cls: Type = None

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def instance(self):
        return self.layer_cls(**self._kwargs)


class AbsmaxObserver(_Factory):
    layer_cls = AbsmaxObserverLayer


class MovingAverageAbsmaxObserver(_Factory):
    layer_cls = MovingAverageAbsmaxObserverLayer


class FakeQuanterWithAbsMaxObserver(_Factory):
    """QAT quanter: observes absmax AND fake-quantizes with STE."""

    class _Layer(MovingAverageAbsmaxObserverLayer):
        def forward(self, x):
            self._observe(x)
            return fake_quant(x, self._scale, bits=self.quant_bits)

    layer_cls = _Layer

    def __init__(self, moving_rate=0.9, quant_bits=8, **kw):
        super().__init__(moving_rate=moving_rate, quant_bits=quant_bits)


observers = type("observers", (), {
    "AbsmaxObserver": AbsmaxObserver,
    "MovingAverageAbsmaxObserver": MovingAverageAbsmaxObserver,
})
quanters = type("quanters", (), {
    "FakeQuanterWithAbsMaxObserver": FakeQuanterWithAbsMaxObserver,
})


# ---------------------------------------------------------------------------
# config (config.py:67 parity subset)
# ---------------------------------------------------------------------------

class QuantConfig:
    def __init__(self, activation: Optional[_Factory] = None,
                 weight: Optional[_Factory] = None):
        self._global_activation = activation
        self._global_weight = weight
        self._type_configs: Dict[type, dict] = {}

    def add_type_config(self, layer_type, activation=None, weight=None):
        if isinstance(layer_type, type):
            layer_type = [layer_type]
        for t in layer_type:
            self._type_configs[t] = {"activation": activation,
                                     "weight": weight}

    def _config_for(self, layer):
        for t, cfg in self._type_configs.items():
            if isinstance(layer, t):
                return cfg
        if self._global_activation or self._global_weight:
            return {"activation": self._global_activation,
                    "weight": self._global_weight}
        return None


# ---------------------------------------------------------------------------
# quantized layer wrappers
# ---------------------------------------------------------------------------

def _call_with_weight(layer, weight, x):
    """``layer(x)`` computing with ``weight`` in place of its own: an
    instance attribute shadows the registered parameter for the call (a
    Module finds ``_parameters`` entries only when normal lookup fails),
    so the parameter itself, its address and its gradient slot stay."""
    layer.__dict__["weight"] = weight
    try:
        return layer(x)
    finally:
        del layer.__dict__["weight"]


class QuantedLayer(torch.nn.Module):
    """Observer/quanter-instrumented wrapper (wrapper.py parity)."""

    def __init__(self, layer, act_factory, weight_factory):
        super().__init__()
        self._inner = layer
        self.act_observer = act_factory.instance() if act_factory else None
        self.weight_observer = (weight_factory.instance()
                                if weight_factory else None)

    def forward(self, x):
        if self.act_observer is not None:
            x = self.act_observer(x)
        if self.weight_observer is not None:
            # a plain observer is the identity; a fake-quanter returns the
            # STE-quantized weight the inner layer must compute with (QAT)
            qw = self.weight_observer(self._inner.weight)
            return _call_with_weight(self._inner, qw, x)
        return self._inner(x)


class ConvertedLayer(torch.nn.Module):
    """Post-convert: quant-dequant with the frozen calibration scales."""

    def __init__(self, quanted: QuantedLayer):
        super().__init__()
        self._inner = quanted._inner
        self._act_scale = (quanted.act_observer.scale()
                           if quanted.act_observer else None)
        self._w_scale = (quanted.weight_observer.scale()
                         if quanted.weight_observer else None)
        any_obs = quanted.act_observer or quanted.weight_observer
        self._bits = any_obs.quant_bits if any_obs is not None else 8

    def forward(self, x):
        if self._act_scale is not None:
            x = fake_quant(x, self._act_scale, bits=self._bits)
        if self._w_scale is not None:
            w = self._inner.weight
            qw = _fake_quant_impl(
                w, torch.tensor(self._w_scale, dtype=torch.float32,
                                device=w.device), bits=self._bits)
            return _call_with_weight(self._inner, qw, x)
        return self._inner(x)


def _walk_swap(model, make):
    """Replace each child ``c`` of every module of ``model`` for which
    ``make(c, parent)`` returns a module. The module list is taken before
    any swap, as the JAX package's ``sublayers()`` list is."""
    for parent in list(model.modules()):
        for name, child in list(parent.named_children()):
            repl = make(child, parent)
            if repl is not None:
                setattr(parent, name, repl)
    return model


def _default_quantizable(layer):
    # Conv2D joins when the port has it (ROADMAP queue A item 7)
    return isinstance(layer, Linear)


class PTQ:
    """Post-training quantization driver (ptq.py:29 parity): quantize()
    instruments, the user runs calibration batches, convert() freezes
    the scales into quant-dequant layers."""

    def __init__(self, config: QuantConfig):
        self._config = config

    def quantize(self, model, inplace: bool = False):
        if not inplace:
            model = copy.deepcopy(model)

        def make(layer, parent=None):
            cfg = self._config._config_for(layer)
            if cfg is None or isinstance(layer, (QuantedLayer,
                                                 ConvertedLayer)):
                return None
            if cfg["activation"] is None and cfg["weight"] is None:
                return None  # nothing to observe or quantize
            if not _default_quantizable(layer):
                return None
            return QuantedLayer(layer, cfg["activation"], cfg["weight"])

        root = make(model)  # the model itself may BE the quantizable layer
        if root is not None:
            return root
        return _walk_swap(model, make)

    def convert(self, model, inplace: bool = False):
        if not inplace:
            model = copy.deepcopy(model)
        if isinstance(model, QuantedLayer):
            return ConvertedLayer(model)
        return _walk_swap(
            model, lambda l, parent=None: ConvertedLayer(l)
            if isinstance(l, QuantedLayer) else None)


class QAT(PTQ):
    """Quantization-aware training (qat.py parity): the same
    instrumentation with fake-quant quanters whose STE lets gradients
    flow."""


# ---------------------------------------------------------------------------
# int8 / int4 weight-only (the serving path)
# ---------------------------------------------------------------------------

def _quantize_weight_int8(w, absmax=None, bits: int = 8):
    """Shared int8 weight grid: step = absmax/qmax (per output channel
    when absmax is None, computed in w's dtype as the JAX package does;
    else the given observer absmax); returns (w_int8, f32 steps)."""
    qmax = 2.0 ** (bits - 1) - 1
    if absmax is None:
        step = ieee_div(torch.clamp(w.abs().amax(dim=0), min=1e-9),
                        qmax)                                     # [out]
    else:
        step = ieee_div(torch.clamp(torch.as_tensor(
            absmax, dtype=torch.float32, device=w.device), min=1e-9), qmax)
    step = step.to(torch.float32)
    w_int8 = torch.clamp(torch.round(w.to(torch.float32) / step),
                         -qmax, qmax).to(torch.int8)
    return w_int8, step.reshape(-1)


def _pack_int4(q):
    """Pack int4 values (an int8 tensor in [-7, 7]) two to a byte along
    the input dim: rows 2k in the low nibble, rows 2k+1 in the high."""
    if q.shape[0] % 2:
        q = torch.cat([q, q.new_zeros((1,) + tuple(q.shape[1:]))], dim=0)
    lo = q[0::2] & 0x0F
    hi = q[1::2] & 0x0F
    return (lo | (hi << 4)).to(torch.int8)


def _unpack_int4(packed):
    """Inverse of _pack_int4 (sign extension by arithmetic shifts of
    int8): returns twice the packed rows."""
    packed = packed.to(torch.int8)
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.stack([lo, hi], dim=1).reshape(
        (-1,) + tuple(packed.shape[1:]))


def _quantize_weight_int4(w, group_size: int = 64):
    """int4 grid with GROUP-WISE scales along the input dim: pad the
    input dim to a multiple of the group, absmax per (group, output
    channel)."""
    qmax = 7.0
    rows = int(w.shape[0])
    g = int(min(group_size, rows))
    pad = (-rows) % g
    wf = w.to(torch.float32)
    if pad:
        wf = torch.cat([wf, wf.new_zeros((pad,) + tuple(w.shape[1:]))],
                       dim=0)
    grouped = wf.reshape(-1, g, w.shape[1])          # [ngroups, g, out]
    step = ieee_div(torch.clamp(grouped.abs().amax(dim=1), min=1e-9), qmax)
    q = torch.clamp(torch.round(grouped / step[:, None, :]), -qmax, qmax)
    q = q.reshape(-1, w.shape[1]).to(torch.int8)
    return _pack_int4(q), step


def dequantize_weight(q, scale, dtype, *, rows=None, group_size=64):
    """Inverse of the quantize_weight_tree grids: the f32 product of the
    int payload and its scales, rounded to ``dtype`` (no scaling after a
    matmul). One kernel writes ``dtype`` directly: torch computes an
    int8 x f32 product in f32 and rounds it on the store, the values of
    ``(q.float() * scale).to(dtype)`` without their f32 temporary. The
    tier follows the scale's rank: [out] is int8 per output channel,
    [ngroups, out] packed int4 with group-wise scales (pass the original
    row count and the group_size used to quantize)."""
    if scale.ndim == 1:                               # int8, [out]
        return torch.mul(q, scale, out=torch.empty(
            q.shape, dtype=dtype, device=q.device))
    if rows is None:
        raise ValueError("int4 dequant needs the original row count")
    g = int(min(group_size, rows))
    ngroups = int(scale.shape[0])
    q4 = _unpack_int4(q)[: ngroups * g].reshape(ngroups, g, -1)
    w = torch.mul(q4, scale[:, None, :], out=torch.empty(
        q4.shape, dtype=dtype, device=q.device))
    return w.reshape(ngroups * g, -1)[:rows]


def quantize_weight_tree(params, *, bits: int = 8, group_size: int = 64,
                         predicate=None):
    """Tree quantizer for the serving sessions: ``params`` is a {name:
    tensor or numpy array} mapping; every entry the predicate selects
    (default: rank-2 weights) is quantized on the shared int8 grid
    (bits=4: packed two nibbles a byte, group-wise scales), on the
    tensor's device. Returns (payloads, f32 scales) by name; entries the
    predicate skips are absent."""
    if bits not in (4, 8):
        raise ValueError(f"unsupported weight bits: {bits}")
    if predicate is None:
        predicate = lambda name, w: w.ndim == 2      # noqa: E731
    qtree, scales = {}, {}
    with torch.no_grad():
        for name, w in params.items():
            w = torch.as_tensor(w).detach()
            if not predicate(name, w):
                continue
            if bits == 8:
                qtree[name], scales[name] = _quantize_weight_int8(w)
            else:
                qtree[name], scales[name] = _quantize_weight_int4(
                    w, group_size=group_size)
    return qtree, scales


class QuantedLinear(torch.nn.Module):
    """Linear with REAL int8 weights and per-output-channel scales; the
    product consumes the dequantized operand."""

    def __init__(self, linear: Linear, bits: int = 8):
        super().__init__()
        w = linear.weight.detach()                    # [in, out]
        w_int8, step = _quantize_weight_int8(w, bits=bits)
        self.register_buffer("weight_int8", w_int8)
        self.register_buffer("scales", step)
        self.bias = linear.bias
        self._dtype = w.dtype

    def forward(self, x):
        # one dequant grid for the module: the eager wrapper and the
        # serving sessions both go through dequantize_weight
        w = dequantize_weight(self.weight_int8, self.scales, self._dtype)
        out = F.matmul(x, w)
        if self.bias is not None:
            out = out + self.bias
        return out


def quantize_weight_only(model, bits: int = 8, inplace: bool = False):
    """Swap every Linear for an int8-weight QuantedLinear."""
    if not inplace:
        model = copy.deepcopy(model)
    if isinstance(model, Linear):
        return QuantedLinear(model, bits=bits)
    return _walk_swap(
        model, lambda l, parent=None: QuantedLinear(l, bits=bits)
        if isinstance(l, Linear) else None)


# ---------------------------------------------------------------------------
# int8 EXECUTION (act + weight int8 products, int32 accumulate)
# ---------------------------------------------------------------------------

def _int_mm(a, b):
    """int8 [M, K] x int8 [K, N] -> int32 [M, N] by ``torch._int_mm``. On
    a card that wants more than 16 rows and K, N multiples of 8, so the
    operands are padded with zeros there (zero rows and columns add
    nothing to the sums) and the product cut back."""
    if a.device.type != "cuda":
        return torch._int_mm(a, b)
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(m, 17) - m, (-k) % 8, (-n) % 8
    if pm or pk:
        a = torch.nn.functional.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = torch.nn.functional.pad(b, (0, pn, 0, pk))
    return torch._int_mm(a, b)[:m, :n]


def _int8_linear_impl(x, w_int8, w_steps, bias, act_step=None):
    """Real int8 product: both operands on int8 grids, an int32
    contraction, rescaled by act_step * weight steps (step = absmax/127).
    act_step None is dynamic per-tensor quantization (absmax taken on
    the fly)."""
    if act_step is None:
        act_step = ieee_div(torch.clamp(x.abs().amax(), min=1e-9), 127.0)
    else:
        act_step = torch.tensor(act_step, dtype=torch.float32,
                                device=x.device)
    xq = torch.clamp(torch.round(x.to(torch.float32) / act_step),
                     -127, 127).to(torch.int8)
    y32 = _int_mm(xq.reshape(-1, xq.shape[-1]), w_int8)
    y32 = y32.reshape(tuple(x.shape[:-1]) + (w_int8.shape[1],))
    y = y32.to(torch.float32) * (act_step * w_steps.to(torch.float32))
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


_INT8_OPDEF = OpDef("int8_linear", _int8_linear_impl, amp="keep")


class Int8ExecLinear(torch.nn.Module):
    """Linear EXECUTED as an int8 x int8 -> int32 product (the act +
    weight tier), built from a calibrated ConvertedLayer (frozen
    observer scales) or directly from a Linear (dynamic per-tensor
    activation scale). Inference only: rounding kills gradients."""

    def __init__(self, linear: Linear, act_scale=None, weight_scale=None,
                 bits: int = 8):
        """act_scale / weight_scale use the OBSERVER convention (absmax,
        the fake-quant grid's full range); None derives them from the
        data (dynamic per tensor for activations, per output channel
        absmax for weights)."""
        super().__init__()
        if bits != 8:
            raise NotImplementedError("int8 execution tier is 8-bit")
        w = linear.weight.detach()                    # [in, out]
        w_int8, step = _quantize_weight_int8(w, absmax=weight_scale)
        self.register_buffer("weight_int8", w_int8)
        self.register_buffer("steps", step)
        self.bias = linear.bias
        self._act_step = (None if act_scale is None
                          else float(np.asarray(act_scale)) / 127.0)

    def forward(self, x):
        return apply_op(_INT8_OPDEF, x, self.weight_int8, self.steps,
                        self.bias, act_step=self._act_step)


def convert_to_int8_exec(model, inplace: bool = False,
                         dynamic: bool = False):
    """Lower quantized layers to REAL int8 execution: a ConvertedLayer
    wrapping a Linear becomes an Int8ExecLinear with its frozen observer
    scales (run PTQ quantize -> calibrate -> convert first).
    ``dynamic=True`` also lowers bare Linears with dynamic per-tensor
    activation quantization; a Linear owned by a quant wrapper stays
    (the wrapper reads its ``_inner.weight``)."""
    if not inplace:
        model = copy.deepcopy(model)

    def make(layer, parent=None):
        if (isinstance(layer, ConvertedLayer)
                and isinstance(layer._inner, Linear)):
            return Int8ExecLinear(layer._inner,
                                  act_scale=layer._act_scale,
                                  weight_scale=layer._w_scale)
        if (dynamic and isinstance(layer, Linear)
                and not isinstance(parent, (QuantedLayer,
                                            ConvertedLayer))):
            return Int8ExecLinear(layer)
        return None

    root = make(model)
    if root is not None:
        return root
    return _walk_swap(model, make)
