"""HBM ledger: who holds device memory, in bytes, right now.
Counterpart of paddle_tpu/observability/memz.py.

Each owner of device memory registers a zero-arg callable returning its
component byte map (the flight recorder's provider pattern), and the
ledger folds them into one ``/memz`` payload + ``memz_bytes{component=...}``
gauges plus a headroom estimate (``PADDLE_MEMZ_HBM_BYTES`` minus the
accounted total).

Component keys are free-form but the serving session uses the canonical
set: ``weights``, ``kv_pool`` (paged-KV slabs, per dtype in the detail)
and ``executables`` (the device memory its captured CUDA graphs hold).
Beside the accounted components, the payload carries the allocator's
own view of the card (``device``: ``torch.cuda.memory_stats`` current
allocated and reserved bytes, ``torch.cuda.max_memory_allocated``) once
CUDA is in use in the process; it is None otherwise. Providers
returning None (weakref'd owner died) are pruned, and a broken provider
reports its error instead of losing the snapshot.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

__all__ = ["register_memz_provider", "unregister_memz_provider",
           "memz_snapshot", "memz_payload", "hbm_budget_bytes",
           "device_memory"]

_PROVIDERS: Dict[str, object] = {}
_LOCK = threading.Lock()


def register_memz_provider(name: str, fn) -> None:
    """Register (or replace) a named ledger provider. ``fn`` must be a
    zero-arg callable returning ``{"components": {name: bytes, ...},
    "detail": {...}}`` (detail optional), or None once its owner is
    gone — the registration is then dropped."""
    with _LOCK:
        _PROVIDERS[name] = fn


def unregister_memz_provider(name: str) -> None:
    with _LOCK:
        _PROVIDERS.pop(name, None)


def hbm_budget_bytes() -> int:
    """The device-memory budget the headroom estimate is computed
    against (``PADDLE_MEMZ_HBM_BYTES``; 0 = unknown, no headroom
    reported)."""
    try:
        return int(os.environ.get("PADDLE_MEMZ_HBM_BYTES", "") or 0)
    except ValueError:
        return 0


def device_memory() -> Optional[dict]:
    """The caching allocator's figures for the current card:
    {allocated_bytes, reserved_bytes, peak_allocated_bytes}, or None
    when CUDA has not been initialized in this process (the ledger never
    initializes it)."""
    import torch

    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {"allocated_bytes": int(stats.get("allocated_bytes.all.current",
                                             0)),
            "reserved_bytes": int(stats.get("reserved_bytes.all.current",
                                            0)),
            "peak_allocated_bytes": int(torch.cuda.max_memory_allocated())}


def memz_snapshot() -> dict:
    """One ledger pass: every provider's component bytes, the summed
    totals, and the headroom estimate. Updates the
    ``memz_bytes{component=...}`` gauges as a side effect so scrapes
    and the ledger always agree."""
    with _LOCK:
        items = list(_PROVIDERS.items())
    providers, dead = {}, []
    totals: Dict[str, int] = {}
    for name, fn in items:
        try:
            state = fn()
        except Exception as e:   # a broken provider must not lose /memz
            providers[name] = {"error": repr(e)}
            continue
        if state is None:
            dead.append(name)
            continue
        comps = {k: int(v) for k, v in
                 (state.get("components") or {}).items()}
        providers[name] = {"components": comps}
        if state.get("detail"):
            providers[name]["detail"] = state["detail"]
        for k, v in comps.items():
            totals[k] = totals.get(k, 0) + v
    if dead:
        with _LOCK:
            for name in dead:
                _PROVIDERS.pop(name, None)
    total = sum(totals.values())
    budget = hbm_budget_bytes()
    doc = {"providers": providers, "totals": totals,
           "total_bytes": total, "hbm_budget_bytes": budget,
           "headroom_bytes": (budget - total) if budget else None,
           "device": device_memory()}
    _update_gauges(totals, total, doc["headroom_bytes"])
    return doc


def _update_gauges(totals: Dict[str, int], total: int,
                   headroom: Optional[int]):
    from . import enabled
    from .metrics import get_registry

    if not enabled():
        return
    reg = get_registry()
    g = reg.gauge("memz_bytes",
                  "accounted device-memory bytes per ledger component")
    for k, v in totals.items():
        g.set(float(v), component=k)
    reg.gauge("memz_total_bytes",
              "accounted device-memory bytes, all components"
              ).set(float(total))
    if headroom is not None:
        reg.gauge("memz_headroom_bytes",
                  "HBM budget minus accounted bytes (negative = "
                  "over-committed vs PADDLE_MEMZ_HBM_BYTES)"
                  ).set(float(headroom))


def memz_payload() -> dict:
    """The /memz endpoint body (adds a wall-clock stamp so fleet-wide
    scrapes can be correlated)."""
    doc = memz_snapshot()
    doc["t_wall"] = time.time()
    return doc
