"""Build the package's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` at the
repository root, where the hash covers the source text and the compiler
flags, so an edited source is rebuilt and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all together, and waits for
them. Nothing is built or imported when this module is imported.
``launch`` calls one entry of a library on the current stream. ptxas
reports each kernel's registers and spills (``-Xptxas -v``); the compiler's
output of each library built in this process is kept in ``compiler_output``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
compiler_output: Dict[str, str] = {}


def sources() -> Dict[str, Path]:
    """Kernel library name -> its CUDA source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(nvcc: str, name: str):
    """Build one library; returns (seconds, None) or (seconds, the error)."""
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(sources()[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    took = time.perf_counter() - t0
    if proc.returncode != 0:
        return took, f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}"
    compiler_output[name] = proc.stdout
    os.replace(tmp, out)
    return took, None


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together. Returns each built library's own compile
    seconds; raises with the compiler's output if any build fails."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    todo = [name for name in names if not library_path(name).exists()]
    if not todo:
        return {}
    with ThreadPoolExecutor(max_workers=len(todo)) as pool:
        done = dict(zip(todo, pool.map(lambda name: _compile(nvcc, name), todo)))
    errors = [err for _, err in done.values() if err]
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: took for name, (took, _) in done.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


_entries: Dict[tuple, object] = {}


def launch(lib: str, name: str, tensors, *scalars) -> None:
    """Call entry ``name`` of library ``lib`` with the pointers of
    ``tensors``, then ``scalars`` (ctypes values: c_int, c_double), then
    the current stream of the tensors' device. Raises TypeError unless every
    tensor is contiguous and on one CUDA device, and RuntimeError when the
    entry returns a CUDA error."""
    device = tensors[0].device
    for t in tensors:
        if t.device != device or device.type != "cuda" or not t.is_contiguous():
            raise TypeError(
                f"{name}: the CUDA kernel takes contiguous tensors on one CUDA device, got "
                f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
    fn = _entries.get((lib, name))
    if fn is None:
        fn = getattr(load(lib), name)
        fn.argtypes = (
            [ctypes.c_void_p] * len(tensors) + [type(s) for s in scalars] + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _entries[(lib, name)] = fn
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*(t.data_ptr() for t in tensors), *scalars, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
