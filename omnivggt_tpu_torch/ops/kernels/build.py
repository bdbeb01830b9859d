"""Build a CUDA source of this package into a shared library, at first use.

Each library is compiled by `nvcc` for `sm_90a` (Hopper) into
`omnivggt_tpu_torch/_build/`, under a file name keyed by a hash of the
source and of the shared headers (csrc/*.cuh), so an edited source builds
anew and an unchanged one is loaded from the last build. `build_all` starts
one nvcc per source at once. The library exposes a plain C interface and is loaded with
`ctypes`; no PyTorch headers are compiled, which keeps a build to seconds.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """The CUDA compiler: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "Hopper kernels are compiled at first use and need the CUDA toolkit"
    )


def library_path(source: str) -> Path:
    """Where the library built from `source` (a file under csrc/) lives."""
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(source: str) -> tuple[Path, str]:
    """Compile csrc/`source` unless its hash-keyed library exists.

    Returns (library path, compiler log; empty when nothing was built).
    The library is written to a temporary name and renamed into place, so
    concurrent builds never load a half-written file."""
    out = library_path(source)
    if out.exists():
        return out, ""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) on {source}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_all(sources) -> dict:
    """Build several sources at once, one nvcc process each; returns
    {source: compiler log}."""
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        return dict(zip(sources, (log for _, log in pool.map(build, sources))))


def load(source: str) -> tuple[ctypes.CDLL, str]:
    """Build (if needed) and load csrc/`source`; returns (library, log)."""
    path, log = build(source)
    return ctypes.CDLL(str(path)), log
