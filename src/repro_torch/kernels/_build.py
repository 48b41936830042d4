"""Build and bind the CUDA kernels: ``nvcc`` into one shared library, ``ctypes``.

Every ``kernels/<name>/kernel.cu`` exposes a plain C launcher (no PyTorch
headers), so each source compiles in seconds. At first use the sources are
compiled in parallel, one ``nvcc`` per file, then linked into one ``.so``
under ``build/`` at the repository root (git-ignored), in a directory keyed
by a hash of the sources and flags: an edited source builds anew, an
unchanged one loads the existing library. Delete ``build/`` to force a
rebuild. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_ROOT = KERNEL_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each launcher: every one returns cudaGetLastError() as int
SIGNATURES = {
    # luts, codes, versions, ids|NULL, out, B, V, M, K, N, C, form, stream
    "repro_pq_adc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, codebooks, codes, N, M, K, dsub, stream
    "repro_pq_encode": [_P, _P, _P, _I, _I, _I, _I, _P],
    # dists, vals, idx, ws|NULL, B, N, L, S, chunk, sort_p, mark_nonfinite, form, stream
    "repro_topk_select": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, x, out, B, N, D, is_bf16, metric_ip, stream
    "repro_flat_l2_dense": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, x, ids, out, B, N, C, D, metric_ip, stream
    "repro_flat_l2_gathered": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}


def sources() -> list[Path]:
    return sorted(KERNEL_DIR.glob("*/kernel.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.parent.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


class BuildInfo:
    """What the last ``library()`` call did: seconds spent and ptxas output."""

    seconds: float = 0.0
    built: bool = False
    log: str = ""
    path: str = ""


def _compile(out_dir: Path) -> tuple[Path, str]:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        obj = out_dir / f"{src.parent.name}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.parent.name}/kernel.cu\n{out}")
        if p.returncode != 0:
            failed.append(src.parent.name)
        objs.append(str(obj))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out_dir / f"lib.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    lib = out_dir / "librepro_torch_kernels.so"
    os.replace(tmp, lib)  # atomic: a concurrent build sees the old file or the new one
    (out_dir / "build.log").write_text("\n".join(log))
    return lib, "\n".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    t0 = time.perf_counter()
    out_dir = _build_dir()
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        BuildInfo.built = False
        log_file = out_dir / "build.log"
        BuildInfo.log = log_file.read_text() if log_file.exists() else ""
    else:
        lib_path, BuildInfo.log = _compile(out_dir)
        BuildInfo.built = True
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    BuildInfo.seconds = time.perf_counter() - t0
    BuildInfo.path = str(lib_path)
    return lib


# each launcher's ctypes function, resolved once
_FUNCTIONS: dict = {}
# the current stream's handle without building a torch.cuda.Stream per call
# (CUDA builds of PyTorch have it; the public call gives the same stream)
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream() -> int:
    """The handle of PyTorch's current stream on the current device."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def launch(name: str, *args) -> None:
    """Call one C launcher on PyTorch's current stream; raise on a CUDA error."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = _FUNCTIONS[name] = getattr(library(), name)
    err = fn(*args, current_stream())
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """All tensors on one CUDA device and contiguous, or raise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
