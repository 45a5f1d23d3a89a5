"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, sm_90a).

Route: ``nvcc`` compiles each source to an object (all started at once),
links them into ``build/repro_torch_kernels/libkernels.so`` at the repo
root, and ``ctypes`` loads it.  The sources expose a plain C interface
(no PyTorch headers), which keeps the build to seconds.  Every pointer
and the stream cross as ``c_void_p`` and every size as ``c_int``; each
entry point returns the ``cudaGetLastError()`` code of its launches,
which ``check`` turns into an exception.

The library is rebuilt when the sources or flags change (a digest is kept
beside it).  The build uses only the sources in this package.  A missing
``nvcc`` or a failed build raises; nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "CSRC", "BUILD_DIR", "build", "load", "check", "stream_of", "require_sm90",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# B5/B6 round: device, vs, scales, ref, out, part, zs, vbar, q1, w, m, d, r,
# rows1, splits1, rows2, splits2, ns_iters, pivot_c, shift_c, grid_out, stream.
_ROUND = (_I, *(_P,) * 9, *(_I,) * 8, _F, _F, _P, _P)
# C signature of every entry point: (argtypes), all return an int status.
_SIGNATURES = {
    "rt_gram_f32": (_I, _P, _P, _I, _I, _I, _I, _P),
    "rt_gram_bf16": (_I, _P, _P, _I, _I, _I, _I, _P),
    "rt_batched_gram": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "rt_batched_gram_polar": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "rt_align_average": (_I, _P, _P, _P, _I, _I, _I, _P),
    "rt_fused_round_f32": _ROUND,
    "rt_fused_round_bf16": _ROUND,
    "rt_fused_round_i8": _ROUND,
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on first use"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``libkernels.so`` unless it is current."""
    sources = sorted(CSRC.glob("*.cu"))
    lib = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources:
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((src, obj, proc))
        failed = []
        for src, _, proc in jobs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name} (rc {proc.returncode}):\n{log}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = Path(tmp) / "libkernels.so"
        link = [nvcc, *ARCH_FLAGS, "-shared", *(str(o) for _, o, _ in jobs),
                "-o", str(out)]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(out, lib)
    stamp.write_text(digest)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device")
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code:
        msg = load().rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_sm90(t: torch.Tensor) -> None:
    """The library is built for sm_90a only: refuse any other card."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}"
        )
