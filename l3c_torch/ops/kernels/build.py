"""Build the CUDA kernels with nvcc and bind them with ctypes.

Each source in `csrc/` has a plain C interface (no PyTorch headers) and
becomes one shared library, so `nvcc` takes seconds per file; all files
compile in parallel, one `nvcc` process each. Libraries go to `_build/`
(listed in .gitignore), named by a hash of source and flags, and are built
at first use. A failed build raises: there is no fallback.

The ctypes argument types are read from the `extern "C"` declarations of
the sources themselves, so there is no second copy of the signatures to
drift from the C; a launch with the wrong number of arguments raises.
(`torch.utils.cpp_extension.load` would compile PyTorch's headers into
the build instead: `time_builds.py` times both routes on the card.)
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              # exact products: float rows round where the plain versions do
              "-fmad=false", "-Xptxas", "-v")

SOURCES = ("float_cdf", "rans")            # csrc/<name>.cu
_C_TYPES = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float}
# every launcher returns its cudaError_t as an int
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(found):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return found


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def signatures(name: str) -> Dict[str, List]:
    """{C function: ctypes argtypes} of the `extern "C"` launchers in
    csrc/<name>.cu, parsed from the source."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    sigs = {}
    for fn, params in _EXTERN.findall(src):
        types = []
        for param in params.split(","):
            words = param.replace("*", " * ").split()
            words = [w for w in words if w != "const"][:-1]   # drop the name
            c_type = "".join(words)
            if c_type not in _C_TYPES:
                raise ValueError(f"{name}.cu: {fn}: unsupported parameter "
                                 f"type {c_type!r}")
            types.append(_C_TYPES[c_type])
        sigs[fn] = types
    if not sigs:
        raise ValueError(f"{name}.cu declares no extern \"C\" launcher")
    return sigs


def _bind(name: str, path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for fn, argtypes in signatures(name).items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def call(name: str, fn: str, *args) -> int:
    """Call launcher `fn` of csrc/<name>.cu (built at first use); returns
    its cudaError_t. ctypes would pass surplus arguments on as varargs, so
    the count is checked here."""
    f = getattr(library(name), fn)
    if len(args) != len(f.argtypes):
        raise TypeError(f"{fn} takes {len(f.argtypes)} arguments, "
                        f"got {len(args)}")
    return f(*args)


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile (if not built yet) and load the named sources, all nvcc
    processes started together."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name in todo:
            out = _lib_path(name)
            if os.path.isfile(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=log,
                                            stderr=subprocess.STDOUT),
                           log, tmp, out)
        failed = []
        for name, (proc, log, tmp, out) in procs.items():
            rc = proc.wait()
            log.close()
            if rc != 0:
                failed.append(name)
            else:
                os.replace(tmp, out)   # atomic: readers never see half
        if failed:
            logs = "\n".join(open(os.path.join(BUILD_DIR, f"{n}.log")).read()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        for name in todo:
            _libs[name] = _bind(name, _lib_path(name))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    if name not in _libs:
        build([name])
    return _libs[name]


def build_log(name: str) -> str:
    """nvcc's output (ptxas register/spill report) of the last build."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    return open(path).read() if os.path.isfile(path) else ""
