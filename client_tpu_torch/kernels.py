"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and bound with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). The build happens on first use, into
``build/client_tpu_torch/`` at the root of the checkout, and is keyed by a
hash of the source and the flags: a changed source builds anew, an
unchanged one loads the library already there.

Nothing here runs at import time; the CPU tests import this module on a
host with no ``nvcc`` and no card.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "client_tpu_torch"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}
#: what ``nvcc`` printed for each built source (ptxas registers and spills)
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (on PATH or at /usr/local/cuda/bin/nvcc); the CUDA "
        "toolkit is needed to build the port's kernels"
    )


def _library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    text = (CSRC_DIR / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}-{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built.

    The compiler writes to a temporary name that is renamed into place,
    so a build cut short never leaves a library that loads."""
    target = _library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    command = [find_nvcc(), *NVCC_FLAGS, "-o", str(partial),
               str(CSRC_DIR / source)]
    proc = subprocess.run(command, capture_output=True, text=True)
    build_logs[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(partial, target)
    return target


def build_all() -> List[Path]:
    """Build every source under ``csrc/``, one ``nvcc`` each, all started
    together (the build is most of a cold start)."""
    sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(build, sources))


def _declare_decode(lib: ctypes.CDLL) -> None:
    """``csrc/paged_attention.cu``: K1, the single-query decode."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rpa_decode.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k_pages, v_pages, tables, positions, out
        i32, i32, i32, i32, i32, i32, i32,  # B, H, KV, D, N, bs, NB
        i32, ctypes.c_float, ptr,  # dtype, scale, stream
    ]
    lib.rpa_decode.restype = i32
    lib.rpa_error_string.argtypes = [i32]
    lib.rpa_error_string.restype = ctypes.c_char_p


def _declare_verify(lib: ctypes.CDLL) -> None:
    """``csrc/paged_attention_mq.cu``: K2, the multi-query verify."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rpa_decode_mq.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr,  # q, k_pages, v_pages, tables, positions, out
        i32, i32, i32, i32, i32, i32, i32, i32,  # B, T, H, KV, D, N, bs, NB
        i32, ctypes.c_float, ptr,  # dtype, scale, stream
    ]
    lib.rpa_decode_mq.restype = i32
    lib.rpa_mq_error_string.argtypes = [i32]
    lib.rpa_mq_error_string.restype = ctypes.c_char_p


# argtypes/restype of each library's C entry points: each pointer and the
# stream as ``c_void_p`` (a bare int would be cut to 32 bits)
_DECLARATIONS = {
    "paged_attention.cu": _declare_decode,
    "paged_attention_mq.cu": _declare_verify,
}


def load(source: str = "paged_attention.cu") -> ctypes.CDLL:
    """The library built from ``csrc/<source>`` (K1's by default), built
    and loaded on first use."""
    with _lock:
        lib = _libraries.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _DECLARATIONS[source](lib)
            _libraries[source] = lib
        return lib
