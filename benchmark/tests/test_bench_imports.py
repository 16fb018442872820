"""Nothing the benchmark runs loads JAX or the JAX package, and the
references load nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

from harness import main

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_names_are_compared_whole(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] in main.FOREIGN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "client_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe.sub", sys)
    assert main.foreign_modules() == []
    monkeypatch.setitem(sys.modules, "client_tpu.models", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert main.foreign_modules() == ["client_tpu", "jax"]


def _loaded_after(code: str) -> set:
    script = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n{code}\n"
              "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_the_run_loads_no_jax():
    loaded = _loaded_after(
        "from harness import main, check, client, devtrace, systems, weights\n"
        "import client_tpu_torch.llm.serving, client_tpu_torch.models.serving\n"
        "import client_tpu_torch.server.core, client_tpu_torch.server.http_server\n"
        "import client_tpu_torch.http.aio\n"
        "import glob\n"
        f"[main.reader(p.split('/')[-1][:-3]) for p in glob.glob({str(BENCH / 'metrics')!r} + '/*.py')]")
    assert "client_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "client_tpu"}


def test_the_references_load_nothing_of_the_port():
    loaded = _loaded_after("from reference import decoder, encoder, linear, tokenizer")
    assert not loaded & {"client_tpu_torch", "client_tpu", "jax", "jaxlib", "flax"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in {"client_tpu_torch", "client_tpu", "jax"}, path
