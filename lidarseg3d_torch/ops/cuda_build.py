"""Build and load the port's hand-written CUDA kernels.

Each source under ``lidarseg3d_torch/csrc/`` is compiled by ``nvcc`` for
Hopper (``sm_90a``) into its own shared library with a plain C interface
and loaded with ``ctypes``; no PyTorch headers are involved, so a build
takes seconds. Libraries land in ``lidarseg3d_torch/build/`` (listed in
``.gitignore``) under a name that carries a hash of the source, so an
edited source is rebuilt and an unchanged one is reused. ``build()``
starts one ``nvcc`` per missing library, all at once.

Nothing here runs at import time: the CPU tests import every module.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = {
    "rank_pack": "rank_pack.cu",
    "rank_lookup": "rank_lookup.cu",
    "rulebook_conv": "rulebook_conv.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs = {}
build_logs = {}


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lidarseg3d_torch are built on the machine "
                           "with the card")
    return path


def library_path(name):
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names=None):
    """Compile every missing library among ``names`` (all by default) in
    parallel; returns the wall seconds spent. Raises with the compiler's
    output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name, signatures):
    """ctypes handle of library ``name``, building it on first use.
    ``signatures`` maps each C function to its argtypes; every function
    returns the launch's cudaError_t as an int."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_of(t):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
