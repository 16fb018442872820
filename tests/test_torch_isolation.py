"""The port stands alone: no JAX, nothing of ``client_tpu``, no silent CPU.

- An AST scan of ``client_tpu_torch/``, ``chip_smoke.py`` and
  ``attention_bench.py`` (which ``chip_smoke.py`` imports) finds no
  import of ``jax``, ``flax``, ``optax`` or ``client_tpu``.
- A subprocess in which importing ``jax`` (or ``client_tpu``) fails
  imports every module of the port.
- On a host with no card, an entry point called without
  ``device="cpu"`` (the LLM engine, the text encoder, the image
  classifier, the built-in models, the server CLI, the TPU shared-memory
  import onto the device) raises instead of running on the CPU.
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
# modules of the latest slice, named so that a scan that missed them fails
SLICE_MODULES = ("client_tpu_torch.models.resnet", "client_tpu_torch.server.shm",
                 "client_tpu_torch.utils.shared_memory",
                 "client_tpu_torch.utils.tpu_shared_memory")


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
    for module in SLICE_MODULES:
        path = ROOT.joinpath(*module.split("."))
        assert path.with_suffix(".py") in files or path / "__init__.py" in files, module
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
    assert set(SLICE_MODULES) <= set(modules)
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


def test_image_and_shm_entry_points_raise_without_a_card(no_card):
    import uuid

    from client_tpu_torch.models import resnet
    from client_tpu_torch.models.serving import ImageClassifierModel
    from client_tpu_torch.utils import tpu_shared_memory as tpushm

    config = resnet.resnet18_thin(dtype=torch.float32)
    region = tpushm.create_shared_memory_region(f"iso_{uuid.uuid4().hex}", 16)
    try:
        tpushm.set_shared_memory_region(region, [np.arange(4, dtype=np.float32)])
        for make in (
            lambda: ImageClassifierModel(),
            lambda: ImageClassifierModel(device="cuda"),
            lambda: resnet.init_params(torch.Generator().manual_seed(0), config),
            lambda: resnet.params_from_jax({"params": {}, "batch_stats": {}}, config),
            lambda: tpushm.as_torch_tensor(region, "FP32", [4]),
            lambda: tpushm.as_torch_tensor(region, "FP32", [4], device="cuda"),
        ):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
        # the CPU is there when asked for
        assert ImageClassifierModel(device="cpu").device.type == "cpu"
        on_cpu = tpushm.as_torch_tensor(region, "FP32", [4], device="cpu")
        assert on_cpu.device.type == "cpu" and on_cpu.tolist() == [0.0, 1.0, 2.0, 3.0]
    finally:
        tpushm.destroy_shared_memory_region(region)


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
