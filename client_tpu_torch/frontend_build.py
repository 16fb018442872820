"""Build and load the native gRPC front-end (``csrc/frontend/``).

Host C++ with a plain C interface (no ``Python.h``, numpy, protobuf or
OpenSSL headers: ``tls.cc`` reaches ``libssl.so.3`` through ``dlopen``),
compiled by ``g++`` into ``build/client_tpu_torch/`` at first use
and bound with :mod:`ctypes`, as :mod:`client_tpu_torch.kernels` builds the
CUDA kernels. The library's name carries a hash of the sources, headers and
flags, so an edit builds anew and an unchanged tree loads what is there.

Several processes may reach the first build at once (test workers, server
processes): they serialize on a file lock, the compiler writes a temporary
name, and a rename puts the library in place, so no process ever loads a
half-written file.
"""

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from client_tpu_torch.kernels import BUILD_DIR, CSRC_DIR

SOURCE_DIR = CSRC_DIR / "frontend"
SOURCES = ("grpc_frontend.cc", "h2_server.cc", "hpack.cc", "tls.cc")
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared", "-pthread"]
# tls.cc reaches libssl.so.3 through dlopen/dlsym, never by linking it
LINK_FLAGS = ["-ldl"]

_lock = threading.Lock()
_library = None


def find_cxx() -> str:
    """The host C++ compiler, ``g++`` on ``PATH``."""
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("no C++ compiler (g++) found to build the gRPC front-end")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sorted(SOURCE_DIR.glob("*")):
        if path.suffix in (".cc", ".h"):
            digest.update(path.name.encode() + path.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"grpc_frontend-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the front-end unless its library is already built."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "grpc_frontend.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():  # another process built it while we waited
            return target
        partial = target.with_suffix(f".{os.getpid()}.tmp")
        command = [find_cxx(), *CXX_FLAGS, "-o", str(partial),
                   *(str(SOURCE_DIR / s) for s in SOURCES), *LINK_FLAGS]
        proc = subprocess.run(command, capture_output=True, text=True)
        if proc.returncode != 0:
            partial.unlink(missing_ok=True)
            raise RuntimeError(f"the gRPC front-end failed to build (exit "
                               f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(partial, target)
    return target


def load() -> ctypes.CDLL:
    """The front-end library, built and loaded on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            u64, i32, ptr = ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p
            lib.ctpu_grpc_start.argtypes = [ptr, i32, ptr, ptr, ptr, i32]
            lib.ctpu_grpc_start.restype = u64
            lib.ctpu_grpc_port.argtypes = [u64]
            lib.ctpu_grpc_port.restype = i32
            lib.ctpu_grpc_stop.argtypes = [u64]
            lib.ctpu_grpc_stop.restype = None
            lib.ctpu_grpc_wait_events.argtypes = [
                u64, i32, i32, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(u64)]
            lib.ctpu_grpc_wait_events.restype = i32
            lib.ctpu_grpc_free.argtypes = [ctypes.c_void_p]
            lib.ctpu_grpc_free.restype = None
            lib.ctpu_grpc_complete.argtypes = [u64, ptr, u64, i32, ptr, i32]
            lib.ctpu_grpc_complete.restype = i32
            lib.ctpu_grpc_complete_rpc.argtypes = [u64, ptr, u64, i32, ptr]
            lib.ctpu_grpc_complete_rpc.restype = i32
            lib.ctpu_grpc_complete_with_metadata.argtypes = [
                u64, ptr, u64, i32, ptr, ptr, u64]
            lib.ctpu_grpc_complete_with_metadata.restype = i32
            _library = lib
        return _library
