"""Optimizer base. Counterpart of paddle_tpu/optimizer/optimizer.py
(parity: python/paddle/optimizer/optimizer.py): ``step`` / ``minimize`` /
``clear_grad``, the learning rate or an ``LRScheduler`` (read once a step
on the host, as the JAX package's ``_refresh_lr`` does), ``grad_clip``,
coupled L2 decay, fp32 master weights (``multi_precision``), the
master-weight-free write-back of low-precision parameters (with
stochastic rounding for bf16), and state dicts.

Updates run in place on the parameters, the masters and the optimizer
state (the JAX package rebinds new arrays; in place saves the memory of
a second copy of each).

State is keyed by parameter name, as the JAX package keys it by
``p.name``: ``{name}_{accumulator}`` (``moment1``, ``moment2``,
``beta1_pow``, ``beta2_pow``, ``moment2_max``), ``{name}_master_weight``,
``global_step`` and ``LR_Scheduler``. A parameter's name is its
``.param_name`` attribute: the port's models give every parameter its
structured name, the ``state_dict`` key it shares with the JAX package
(``nn.layer.common.name_parameters``); a parameter without one is
``param_{i}``, i its place in ``parameters``. The beta powers are host
fp32 scalars (their state-dict entries 0-d fp32 CPU tensors), so a step
reads nothing back from the card.
"""
from __future__ import annotations

import binascii
import numbers

import numpy as np
import torch

from .lr import LRScheduler

# accumulators kept as host fp32 scalars
_HOST_SCALARS = ("beta1_pow", "beta2_pow")


def stochastic_round_bf16(x32, generator):
    """Unbiased fp32 -> bf16 rounding (the JAX package's
    ``_stochastic_round_bf16``): add 16 random low bits to the fp32 bit
    pattern, then truncate. P(round up) is the truncated fraction, so
    E[rounded] = x; representable values never move; inf and NaN stay
    (the largest finite values may round to inf, as in the JAX package).
    The bits are drawn as int32 from ``generator`` (Philox on a card,
    where the JAX package uses threefry, so the two draw different
    bits)."""
    bits = x32.view(torch.int32)
    rnd = torch.randint(0, 1 << 16, x32.shape, dtype=torch.int32,
                        device=x32.device, generator=generator)
    out = (bits + rnd) & -65536          # & 0xFFFF0000
    return out.view(torch.float32).to(torch.bfloat16)


def _state_value(src):
    """A state-dict entry (tensor, array or number) as a tensor."""
    if isinstance(src, torch.Tensor):
        return src
    arr = np.asarray(src)
    if arr.dtype.name == "bfloat16":          # numpy has no bf16: widen
        return torch.tensor(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.tensor(arr)


class Optimizer:
    # bf16-state training knobs (set by Adam / AdamW)
    _moment_dtype = None          # None -> fp32 moment storage
    _stochastic_rounding = False  # unbiased bf16 write-back without masters

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision: bool = False):
        if parameters is None:
            raise ValueError("parameters is required (pass "
                             "model.parameters())")
        if not isinstance(learning_rate, (numbers.Real, LRScheduler)):
            raise TypeError(f"learning_rate must be a float or an "
                            f"LRScheduler, got {type(learning_rate)}")
        self._parameter_list = list(parameters)
        self._names = {}
        for i, p in enumerate(self._parameter_list):
            pname = getattr(p, "param_name", None)
            pname = pname if isinstance(pname, str) else f"param_{i}"
            if pname in self._names.values():
                raise ValueError(f"two parameters are named {pname!r}")
            self._names[id(p)] = pname
        self._learning_rate = learning_rate
        self._lr_scheduler = (learning_rate if isinstance(
            learning_rate, LRScheduler) else None)
        self._weight_decay = weight_decay
        self._decay_coeff()     # a string mode raises here, not at step 1
        self._grad_clip = grad_clip
        self._multi_precision = bool(multi_precision)
        # accumulators[accumulator][param name] -> tensor (or host fp32
        # scalar for the beta powers); masters by parameter identity
        self._accumulators = {}
        self._pending_state = {}
        self._master_weights = {}
        self._step_count = 0
        self._sr_generators = {}

    def _name(self, p) -> str:
        return self._names[id(p)]

    # -- lr ---------------------------------------------------------------
    def get_lr(self) -> float:
        if self._lr_scheduler is not None:
            return float(self._lr_scheduler.get_lr())
        return float(self._learning_rate)

    def set_lr(self, value) -> None:
        if self._lr_scheduler is not None:
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._learning_rate = float(value)

    def set_lr_scheduler(self, scheduler) -> None:
        self._lr_scheduler = scheduler

    # -- accumulators -----------------------------------------------------
    def _adopt(self, key, p, dtype=None):
        """The pending state-dict entry ``key`` for parameter ``p`` (on its
        device; cast to ``dtype`` if given), removed from the pending
        entries, or None."""
        src = self._pending_state.pop(key, None)
        if src is None:
            return None
        t = _state_value(src)
        return t.to(device=p.device, dtype=dtype or t.dtype, copy=True)

    def _accum(self, name, p, init=0.0, dtype=torch.float32,
               cast_pending=False):
        """The accumulator ``name`` of ``p``: created from a pending
        state-dict entry (in its own dtype, or ``dtype`` with
        ``cast_pending``) or filled with ``init`` at first use. The beta
        powers are host fp32 scalars."""
        pname = self._name(p)
        store = self._accumulators.setdefault(name, {})
        if pname not in store:
            key = f"{pname}_{name}"
            if name in _HOST_SCALARS:
                src = self._pending_state.pop(key, None)
                store[pname] = np.float32(
                    init if src is None else float(_state_value(src)))
            else:
                t = self._adopt(key, p, dtype if cast_pending else None)
                store[pname] = t if t is not None else torch.full(
                    p.shape, init, dtype=dtype, device=p.device)
        return store[pname]

    def _master_weight(self, p):
        """The fp32 master of a low-precision parameter under
        ``multi_precision`` (from a pending state-dict entry, or created
        from the parameter at first use), or None."""
        if not self._multi_precision or p.dtype == torch.float32:
            return None
        if id(p) not in self._master_weights:
            m = self._adopt(f"{self._name(p)}_master_weight", p)
            self._master_weights[id(p)] = (
                m if m is not None else p.detach().float().clone())
        return self._master_weights[id(p)]

    def _param32(self, p):
        """The fp32 value an update reads and writes: the master, the
        parameter itself when it is fp32 (updated in place), else a fp32
        copy of the low-precision parameter (written back by
        :meth:`_finish_update`)."""
        m = self._master_weight(p)
        if m is not None:
            return m
        return p.data if p.dtype == torch.float32 else p.detach().float()

    def _moment_store_dtype(self):
        md = self._moment_dtype
        if md is None or md in ("float32", torch.float32):
            return torch.float32
        if md in ("bfloat16", torch.bfloat16):
            return torch.bfloat16
        # a typo ('bf16') silently storing fp32 moments would defeat the
        # memory plan and run out of memory with no hint why
        raise ValueError(f"moment_dtype must be None, 'float32' or "
                         f"'bfloat16'; got {md!r}")

    # -- write-back -------------------------------------------------------
    def _sr_generator(self, p):
        """The stochastic-rounding generator of ``p``'s device, seeded for
        (parameter, step): a crc32 of the name (as the JAX package's
        ``_sr_pid``) in the high 32 bits, the step count in the low."""
        g = self._sr_generators.get(p.device)
        if g is None:
            g = self._sr_generators[p.device] = torch.Generator(
                device=p.device)
        pid = binascii.crc32(self._name(p).encode()) & 0x7FFFFFFF
        g.manual_seed((pid << 32) | (self._step_count & 0xFFFFFFFF))
        return g

    def _finish_update(self, p, new32):
        """Write the fp32 result ``new32`` (from :meth:`_param32`) back:
        through the master (rounded to nearest into the parameter), in
        place for fp32 parameters, else into the low-precision parameter,
        by stochastic rounding for bf16 under ``stochastic_rounding``."""
        if new32.data_ptr() == p.data_ptr():
            return
        if (self._stochastic_rounding and p.dtype == torch.bfloat16
                and id(p) not in self._master_weights):
            p.copy_(stochastic_round_bf16(new32, self._sr_generator(p)))
        else:
            p.copy_(new32)

    # -- step -------------------------------------------------------------
    @torch.no_grad()
    def step(self):
        lr = np.float32(self.get_lr())
        params_grads = [(p, p.grad) for p in self._parameter_list
                        if p.requires_grad and p.grad is not None]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        self._step_count += 1
        if params_grads:
            self._update(params_grads, lr)

    def _update(self, params_grads, lr):
        raise NotImplementedError

    def _decay_coeff(self):
        """The coupled L2 coefficient (a float, or an object with
        ``coeff``), or None."""
        wd = self._weight_decay
        if wd is None:
            return None
        if isinstance(wd, str):
            raise NotImplementedError(
                "string regularizer modes are not ported; pass a float L2 "
                "coefficient")
        return float(getattr(wd, "coeff", wd))

    def _apply_decay(self, p32s, g32s):
        """Coupled L2 folded into the gradients: g + coeff * p (fp32, new
        tensors; the parameters' gradients are left as they are)."""
        coeff = self._decay_coeff()
        if coeff is None:
            return g32s
        return torch._foreach_add(g32s, torch._foreach_mul(p32s, coeff))

    def minimize(self, loss, startup_program=None, parameters=None,
                 no_grad_set=None):
        loss.backward()
        self.step()
        return None, [(p, p.grad) for p in self._parameter_list]

    def clear_grad(self, set_to_zero: bool = False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    # -- state dict -------------------------------------------------------
    def state_dict(self):
        """``{name}_{accumulator}``, ``{name}_master_weight``,
        ``global_step`` (0-d int32) and, under a scheduler,
        ``LR_Scheduler``; entries loaded but not used yet round-trip. The
        tensors are the live state."""
        sd = dict(self._pending_state)
        for name, store in self._accumulators.items():
            for pname, t in store.items():
                sd[f"{pname}_{name}"] = (torch.tensor(t) if name in
                                         _HOST_SCALARS else t)
        for pid, t in self._master_weights.items():
            sd[f"{self._names[pid]}_master_weight"] = t
        sd["global_step"] = torch.tensor(self._step_count, dtype=torch.int32)
        if self._lr_scheduler is not None:
            sd["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return sd

    @staticmethod
    def _loaded(name, src, old):
        """The live value of a loaded entry replacing ``old``."""
        if name in _HOST_SCALARS:
            return np.float32(float(_state_value(src)))
        return _state_value(src).to(device=old.device, copy=True)

    def set_state_dict(self, sd):
        """Load ``sd`` (tensors, arrays or numbers): live accumulators and
        masters take their entries now, the rest wait until their
        parameter's first use (or :meth:`materialize_state`)."""
        self._pending_state.clear()
        consumed = set()
        for name, store in self._accumulators.items():
            for pname in list(store):
                key = f"{pname}_{name}"
                if key in sd:
                    consumed.add(key)
                    store[pname] = self._loaded(name, sd[key], store[pname])
        for pid, old in list(self._master_weights.items()):
            key = f"{self._names[pid]}_master_weight"
            if key in sd:
                consumed.add(key)
                self._master_weights[pid] = self._loaded("master_weight",
                                                         sd[key], old)
        for key, src in sd.items():
            if key not in consumed and key not in ("global_step",
                                                   "LR_Scheduler"):
                self._pending_state[key] = src
        if "global_step" in sd:
            self._step_count = int(_state_value(sd["global_step"]))
        if "LR_Scheduler" in sd and self._lr_scheduler is not None:
            self._lr_scheduler.set_state_dict(sd["LR_Scheduler"])

    load_state_dict = set_state_dict

    def materialize_state(self):
        """Turn every pending entry that names a parameter of this
        optimizer into live state now instead of at first use (the
        accumulator's dtype is the entry's own)."""
        # longest first, so a name that prefixes another cannot take its
        # entries
        params = sorted(self._parameter_list,
                        key=lambda q: len(self._name(q)), reverse=True)
        for key in list(self._pending_state):
            p = next((q for q in params
                      if key.startswith(self._name(q) + "_")), None)
            if p is None:
                continue
            accum = key[len(self._name(p)) + 1:]
            if accum == "master_weight":
                self._master_weights[id(p)] = self._adopt(key, p)
            else:
                self._accum(accum, p)


__all__ = ["Optimizer", "stochastic_round_bf16"]
