"""The port stands alone: no JAX, nothing of ``client_tpu``, no silent CPU.

- An AST scan of ``client_tpu_torch/``, ``chip_smoke.py`` and
  ``attention_bench.py`` (which ``chip_smoke.py`` imports) finds no
  import of ``jax``, ``flax``, ``optax`` or ``client_tpu``.
- A subprocess in which importing ``jax`` (or ``client_tpu``) fails
  imports every module of the port.
- On a host with no card, an entry point called without
  ``device="cpu"`` (the LLM engine, the text encoder, the built-in
  models, the server CLI) raises instead of running on the CPU.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from client_tpu_torch.models import llama
from client_tpu_torch.utils import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "client_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "client_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "attention_bench.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_client_tpu():
    files = _port_files()
    assert len(files) > 10
    offenders = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name.split(".")[0] in FORBIDDEN
    ]
    assert offenders == []


def test_every_port_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(path.relative_to(ROOT).with_suffix("").parts)
        for path in PORT.rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m for m in modules]
    script = (
        "import importlib, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"for module in {modules!r}:\n"
        "    importlib.import_module(module)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("imported")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from client_tpu_torch.llm.serving import LlmEngineModel

    config = llama.LlamaConfig.tiny(dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlmEngineModel(config=config)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_kv_pages(config, 4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(torch.Generator().manual_seed(0), config)
    # asking for the CPU is the one way onto it
    assert resolve_device("cpu") == torch.device("cpu")
    assert llama.init_kv_pages(config, 4, 8, device="cpu")[0][0].device.type == "cpu"


def test_kserve_entry_points_raise_without_a_card(no_card):
    from client_tpu_torch.models import bert
    from client_tpu_torch.models.serving import TextEncoderModel, register_zoo_models
    from client_tpu_torch.server import models
    from client_tpu_torch.server.__main__ import main
    from client_tpu_torch.server.model_repository import ModelRepository

    config = bert.BertConfig.tiny(dtype=torch.float32)
    for make in (
        lambda: TextEncoderModel(),
        lambda: TextEncoderModel(device="cuda"),
        lambda: bert.init_params(torch.Generator().manual_seed(0), config),
        lambda: bert.params_from_jax({}, config),
        lambda: models.AddSubModel(),
        lambda: models.IdentityModel(),
        lambda: models.BytesIdentityModel(),
        lambda: models.register_builtin_models(ModelRepository()),
        lambda: register_zoo_models(ModelRepository()),
        lambda: models.run_bucketed(lambda x: (x,), np.zeros([1, 2]),
                                    device=resolve_device(None)),
        lambda: main(["--http-port", "0"]),
        lambda: main(["--http-port", "0", "--no-builtin-models", "--zoo-models"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # the CPU is there when asked for
    assert TextEncoderModel(device="cpu").device.type == "cpu"
    repository = ModelRepository()
    models.register_builtin_models(repository, device="cpu")
    assert [m["state"] for m in repository.index()] == ["READY"] * 4


def test_kernel_build_needs_nvcc(monkeypatch):
    from client_tpu_torch import kernels

    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_chip_smoke_alone_exits_nonzero_without_a_result(tmp_path):
    """In a directory holding nothing else of the repo (and, here, with
    no card) the smoke run fails and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
