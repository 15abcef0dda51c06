"""Import guard of the PyTorch port: gridllm_torch and chip_smoke.py import
neither JAX nor anything of gridllm_tpu, nor pydantic, aiohttp,
safetensors, transformers or tokenizers when a module is imported (the
card's machine has none of the last three; the worker's health port
imports aiohttp inside its function), and the engine refuses to run
on a missing GPU instead of carrying on on the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gridllm_torch.engine import EngineConfig, InferenceEngine

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "gridllm_tpu")
# never imported while a port module is imported (the card's machine has
# none of the last three: the port reads and writes safetensors itself, and
# transformers is imported only inside HFTokenizer)
IMPORT_TIME_BLOCKED = ("pydantic", "aiohttp", "safetensors", "transformers", "tokenizers")

_GUARDED_IMPORT = """
import importlib, importlib.abc, importlib.util, pkgutil, sys
BLOCKED = {blocked!r}

def blocked(name):
    return name.split(".")[0] in BLOCKED

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if blocked(name):
            raise ImportError("blocked import: " + name)
        return None

sys.meta_path.insert(0, Block())
import gridllm_torch
names = [m.name for m in pkgutil.walk_packages(gridllm_torch.__path__, "gridllm_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not [m for m in sys.modules if blocked(m)], "a blocked module got imported"
print("IMPORTED", len(names))
"""


def test_port_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-c", _GUARDED_IMPORT.format(blocked=BLOCKED + IMPORT_TIME_BLOCKED)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout


def _port_files() -> list[Path]:
    return sorted((REPO / "gridllm_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    in_function = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            in_function.update(id(n) for n in ast.walk(fn))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in BLOCKED, f"{path}:{node.lineno} imports {name}"
            assert top not in IMPORT_TIME_BLOCKED or id(node) in in_function, \
                f"{path}:{node.lineno} imports {name} outside a function"


def test_engine_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(EngineConfig(model="tiny-llama"))


@pytest.mark.parametrize("field,value", [
    ("checkpoint_path", "weights"), ("quantize", "int8"),
    ("kv_host_bytes", 1 << 20), ("draft_checkpoint", "weights"), ("mesh", object()),
])
def test_unported_engine_features_raise(field, value):
    """Unported settings raise NotImplementedError naming the field; the
    checkpoint settings are served since checkpoints were ported, so a
    missing directory fails its load instead of being refused, the host KV
    tier since it was ported, so the engine builds one, and int8 weights
    since they were ported, so the engine's projections are int8."""
    if field == "quantize":
        eng = InferenceEngine(EngineConfig(model="tiny-llama", dtype="float32",
                                           **{field: value}), device="cpu")
        assert eng.model.quantize == value and eng.model.layers["wq"].dtype == torch.int8
        return
    if field == "kv_host_bytes":
        eng = InferenceEngine(EngineConfig(model="tiny-llama", dtype="float32",
                                           **{field: value}), device="cpu")
        assert eng.host_tier is not None and eng.host_tier.capacity_bytes == value
        return
    if field in ("checkpoint_path", "draft_checkpoint"):
        extra = {"draft_model": "tiny-llama"} if field == "draft_checkpoint" else {}
        cfg = EngineConfig(model="tiny-llama", dtype="float32", **{field: value}, **extra)
        with pytest.raises(FileNotFoundError, match=value):
            InferenceEngine(cfg, device="cpu")
        return
    cfg = EngineConfig(model="tiny-llama", dtype="float32", **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        InferenceEngine(cfg, device="cpu")


def test_kernel_build_is_content_addressed_and_needs_nvcc(monkeypatch, tmp_path):
    """Libraries are named by a hash of the sources (an edited kernel never
    loads a stale build), and building without nvcc raises instead of
    leaving the package half-working."""
    from gridllm_torch.ops import _build

    paths = {src: _build._lib_path(src) for src in _build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    assert all(p.parent == _build.BUILD_DIR for p in paths.values())
    assert paths["paged_write.cu"] == _build._lib_path("paged_write.cu")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


@pytest.mark.parametrize("rows,rpw", [(1, 1), (4, 1), (5, 2), (8, 2), (20, 8), (32, 8), (64, 8)])
def test_rows_per_warp_covers_the_block(rows, rpw):
    from gridllm_torch.ops.cuda_kernels import _rows_per_warp

    assert _rows_per_warp(rows) == rpw


@pytest.mark.parametrize("rows,rpw", [(1, 1), (2, 1), (5, 2), (10, 4), (12, 4), (20, 4),
                                      (64, 4)])
def test_rows_per_warp_at_head_dim_256_stays_at_four(rows, rpw):
    """gemma2's head dim: at most 4 rows a warp (8 are not compiled there);
    more rows take more passes of the block."""
    from gridllm_torch.ops.cuda_kernels import _rows_per_warp

    assert _rows_per_warp(rows, 256) == rpw
    assert _rows_per_warp(rows, 128) == _rows_per_warp(rows)
