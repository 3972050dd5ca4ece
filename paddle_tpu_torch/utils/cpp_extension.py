"""Build C++ host ops and register them. Counterpart of
paddle_tpu/utils/cpp_extension.py (Paddle's
``paddle.utils.cpp_extension.load``).

Device code belongs in a CUDA kernel registered through
``ops.register_op``; C++ here is for HOST ops (custom data transforms,
CPU-side scoring, legacy numeric code), as in the JAX package, where the
C function runs through ``jax.pure_callback``. Here the op copies its
input to the host, so on the card each call makes a host round trip by
design.

C ABI contract (checked at load): each exported op is

    extern "C" void <name>(const float* in, float* out, int64_t n);

an elementwise float32 map over n elements. The sources are built with
``g++ -O2 -shared -fPIC`` into ``build/paddle_tpu_torch/extensions/``
at the repository root, named by a hash of the sources and flags (an
edit rebuilds), and bound with ``ctypes``. ``torch.utils.cpp_extension``
is not used: it compiles against PyTorch's headers (minutes a build) for
a different ABI.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

from ..csrc import BUILD_DIR

BUILD_ROOT = BUILD_DIR / "extensions"


def _build(name: str, sources: Sequence[str],
           extra_cflags: Sequence[str] = ()) -> Path:
    """g++ the sources into a cached shared library; returns its path.
    Raises RuntimeError with the compiler's output if the build fails."""
    h = hashlib.sha256()
    for s in sources:
        h.update(Path(s).read_bytes())
    h.update(" ".join(extra_cflags).encode())
    so = BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_ROOT.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
               *map(str, sources), *extra_cflags]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"cpp_extension build failed for {name}:\n{proc.stderr}")
        os.replace(tmp, so)     # atomic: readers never see a partial file
    return so


def load(name: str, sources: Sequence[str], functions: Sequence[str],
         vjps: Optional[dict] = None,
         extra_cflags: Sequence[str] = ()) -> dict:
    """Compile ``sources`` and register each listed C function as the op
    ``"<name>.<function>"``.

    functions: exported symbol names (see the C ABI contract above).
    vjps: optional {function: (fwd, bwd)} custom-VJP pairs in torch (see
        ``ops.register_op``); without one a gradient through the op
        raises RuntimeError naming it, as a custom op without a grad
        kernel does.
    Returns {function: dispatcher}.
    """
    from ..ops.custom import register_op

    so = _build(name, sources, extra_cflags)
    lib = ctypes.CDLL(str(so))
    out = {}
    for fname in functions:
        try:
            cfn = getattr(lib, fname)
        except AttributeError:
            raise RuntimeError(
                f"{so} does not export {fname!r}: declare it extern \"C\"")
        cfn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        cfn.restype = None
        op_name = f"{name}.{fname}"
        out[fname] = register_op(op_name, _host_impl(cfn, op_name),
                                 vjp=(vjps or {}).get(fname))
    return out


class _HostOp(torch.autograd.Function):
    """A C function over float32 on the host. Its gradient raises."""

    @staticmethod
    def forward(ctx, cfn, op_name, x):
        ctx.op_name = op_name
        xh = x.detach().to("cpu", torch.float32).contiguous()
        y = torch.empty_like(xh)
        cfn(xh.data_ptr(), y.data_ptr(), xh.numel())
        return y.to(x.device)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(
            f"op {ctx.op_name!r} has no gradient: it was loaded by "
            f"cpp_extension.load without a vjp")


def _host_impl(cfn, op_name: str) -> Callable:
    """The op's impl: copy x to the host as contiguous float32, call the
    C function, return float32 of x's shape on x's device."""

    def impl(x):
        return _HostOp.apply(cfn, op_name, x)

    impl.__name__ = op_name
    return impl


__all__ = ["BUILD_ROOT", "load"]
