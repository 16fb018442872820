"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` into a shared
library with a plain C interface and bound with :mod:`ctypes` (no PyTorch
headers, so a build takes seconds). The build happens on first use, into
``build/client_tpu_torch/`` at the root of the checkout, and is keyed by a
hash of the source, every header under ``csrc/`` and the flags: a changed
source or shared header builds anew, an unchanged one loads the library
already there.

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
    """Where the library built from ``csrc/<source>`` lives: the key
    covers the source, every ``csrc/*.cuh`` (the sources share one) and
    the flags."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


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


_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
# the split-KV arguments both entry points end with: partition, workspace,
# its size in floats, counters, their count
_SPLIT_ARGS = [_I32, _PTR, ctypes.c_longlong, _PTR, _I32]
# dtype, head_dim, rows a block (K1: the group size), partition,
# *smem_bytes, *blocks_per_sm
_DESCRIBE_ARGS = [_I32, _I32, _I32, _I32, ctypes.POINTER(_I32), ctypes.POINTER(_I32)]


def _declare_decode(lib: ctypes.CDLL) -> None:
    """``csrc/paged_attention.cu``: K1, the single-query decode."""
    lib.rpa_decode.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # q, k_pages, v_pages, tables, positions, out
        _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # B, H, KV, D, N, bs, NB
        _I32, ctypes.c_float, _PTR,  # dtype, scale, stream
        *_SPLIT_ARGS,
    ]
    lib.rpa_decode.restype = _I32
    lib.rpa_describe.argtypes = _DESCRIBE_ARGS
    lib.rpa_describe.restype = _I32
    lib.rpa_error_string.argtypes = [_I32]
    lib.rpa_error_string.restype = ctypes.c_char_p


def _declare_verify(lib: ctypes.CDLL) -> None:
    """``csrc/paged_attention_mq.cu``: K2, the multi-query verify."""
    lib.rpa_decode_mq.argtypes = [
        _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,  # q, k_pages, v_pages, tables, positions, out
        _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32,  # B, T, H, KV, D, N, bs, NB
        _I32, ctypes.c_float, _PTR,  # dtype, scale, stream
        *_SPLIT_ARGS,
    ]
    lib.rpa_decode_mq.restype = _I32
    lib.rpa_mq_describe.argtypes = _DESCRIBE_ARGS
    lib.rpa_mq_describe.restype = _I32
    lib.rpa_mq_error_string.argtypes = [_I32]
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
