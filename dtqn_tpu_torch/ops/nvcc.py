"""Builds a CUDA C++ source of ``dtqn_tpu_torch/csrc`` for sm_90a into a
shared library with a plain C interface, once, and loads it with ctypes.

``nvcc`` runs at a library's first use on the GPU; the library lands under
``dtqn_tpu_torch/_build/`` (git-ignored), named by the source's stem and a
hash of the source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is.  Beside it, ``<name>.log`` keeps
``nvcc``'s output (``-Xptxas -v``: each kernel's registers and spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc(source: Path) -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found (set CUDA_HOME): {source.name}'s kernels are built "
        "from dtqn_tpu_torch/csrc at first use on the GPU"
    )


def build_library(source: Path, build_dir: Path = BUILD_DIR,
                  verbose: bool = False) -> ctypes.CDLL:
    """Compiles ``source`` with ``NVCC_FLAGS`` into ``build_dir`` unless a
    library of the same source and flags is there, and loads it."""
    text = source.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    lib_path = build_dir / f"{source.stem}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        nvcc = find_nvcc(source)
        build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
        os.close(fd)
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)  # atomic: concurrent builds agree
    return ctypes.CDLL(str(lib_path))


def raise_on_error(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises when a C entry point returned a CUDA error: every library
    exports ``dtqn_cuda_error_string``."""
    if code != 0:
        msg = lib.dtqn_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code}: {msg}")
