"""The port stands alone and never runs on the CPU unasked.

- No module of paddle_tpu_torch, nor chip_smoke.py, imports JAX or the
  JAX package: checked in the source (AST) and by importing every module
  of the port in a fresh interpreter.
- Without a card, an entry point called with no device= raises.
- GenerationSession options the port lacks raise.

These rules belong to the port alone: no test of the JAX package is
shadowed here.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "paddle_tpu_torch"


def _forbidden(mod: str) -> bool:
    root = mod.split(".")[0]
    return root in ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_importing_every_port_module_loads_no_jax():
    code = f"""
import json, pkgutil, sys, importlib
sys.path.insert(0, {str(REPO)!r})
before = set(sys.modules)
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
new = sorted(set(sys.modules) - before)
print(json.dumps(new))
"""
    res = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    new = json.loads(res.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.inference.serving" in new
    assert not [m for m in new if m.split(".")[0] in
                ("jax", "jaxlib", "paddle_tpu")]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_when_no_card(no_card):
    from paddle_tpu_torch import core
    from paddle_tpu_torch.incubate.nn.functional import paged_kv
    from paddle_tpu_torch.models import (GPTForCausalLM, LlamaForCausalLM,
                                         gpt_tiny, llama_tiny)

    for build in (lambda: LlamaForCausalLM(llama_tiny()),
                  lambda: GPTForCausalLM(gpt_tiny()),
                  lambda: core.seed(0),
                  lambda: paged_kv.init_block_cache(4, 2, 4, 8),
                  lambda: paged_kv.alloc_block_tables(2, 16, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # an explicit CPU request still works
    assert core.resolve_device("cpu").type == "cpu"
    assert core.resolve_device(core.CPUPlace()).type == "cpu"


@pytest.mark.parametrize("kwargs", [
    {"speculative": {"num_draft_tokens": 3}}, {"lora": object()},
    {"quantize_weights": "int8"}, {"kv_dtype": "int8"}])
def test_unported_session_options_raise(kwargs):
    from paddle_tpu_torch.inference.serving import (GenerationSession,
                                                    aot_generate)
    from paddle_tpu_torch.models import GPTForCausalLM, gpt_tiny

    model = GPTForCausalLM(gpt_tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        GenerationSession(model, batch=1, prompt_len=4, max_new_tokens=2,
                          **kwargs)
    with pytest.raises(NotImplementedError):
        aot_generate(model, np.ones((1, 4), np.int64), 2, **kwargs)
