"""Build and load the CUDA kernels of ``tpujoin_torch/csrc``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc``, all started together,
and the objects are linked into one shared library with a plain C
interface, ``tpujoin_torch/build/libtpujoin_kernels.so``, at first use and
again whenever a source or the flags change (the build records the
sources' hash beside the library). The library is loaded with ctypes: no
PyTorch headers are compiled, which keeps a build to seconds.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`call` raises when that is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
LIB_NAME = "libtpujoin_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

P, I64 = ctypes.c_void_p, ctypes.c_int64
# argtypes of every entry point; the trailing pointer is the CUDA stream
_SIGNATURES = {
    "tj_block_sort": (P, P, P, P, I64, P),
    "tj_merge_pass": (P, P, P, P, I64, I64, P),
    "tj_merge_count": (P, I64, P, I64, P, P, P),
    "tj_compact_count": (P, I64, I64, P, P),
    "tj_compact_ids": (P, I64, I64, P, P, P, I64, P),
    "tj_compact_cols": (P, I64, I64, P, P, I64, P, P, I64, P),
    "tj_expand": (P, P, P, I64, P, P, I64, P),
    "tj_expand_fill": (P, P, I64, P, P, P, I64, P, I64, I64, P, P, I64, P),
    "tj_expand_runs": (P, P, P, I64, P, I64, I64, P, P, I64, P),
    "tj_stream_scale": (P, P, I64, P),
    "tj_smem_gather": (P, I64, P, P, I64, P),
    "tj_carry_scan": (P, P, I64, P, I64, P),
    "tj_shift_loop": (P, P, I64, I64, P),
}

_lib: ctypes.CDLL | None = None


def find_nvcc() -> str:
    """nvcc from ``CUDA_HOME``, else ``PATH``, else PyTorch's guess of the
    toolkit's home."""
    def in_home(home):
        nvcc = Path(home) / "bin" / "nvcc" if home else None
        return str(nvcc) if nvcc and nvcc.is_file() else None

    found = in_home(os.environ.get("CUDA_HOME")) or shutil.which("nvcc")
    if not found:
        from torch.utils import cpp_extension
        found = in_home(cpp_extension.CUDA_HOME)
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the library unless the one on disk matches the sources.
    Returns its path; raises with nvcc's output when the compile fails."""
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest()
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = find_nvcc(), os.getpid()
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}.tmp"
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in srcs]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(srcs, objs)]
    try:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for cmd in cmds]
        results = [(cmd, proc, *proc.communicate())
                   for cmd, proc in zip(cmds, procs)]
        for cmd, proc, out, err in results:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}\n{err}")
        link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(link)}\n{proc.stdout}"
                               f"\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        for path in (tmp, *objs):
            path.unlink(missing_ok=True)
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(loaded, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        loaded.tj_error_string.argtypes = [ctypes.c_int]
        loaded.tj_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def call(name: str, device: torch.device, *args) -> None:
    """Launch entry point ``name`` on ``device``'s current stream; raise on
    error."""
    fn = getattr(lib(), name)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib().tj_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def check_cuda_i32(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous 1-D int32 tensor on one
    CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"expected CUDA tensors on one device, got "
                             f"{[str(x.device) for x in tensors]}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"expected contiguous 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain version runs."""
    return all(t.device.type == "cpu" for t in tensors)
