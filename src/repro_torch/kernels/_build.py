"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, sm_90a).

Route: ``nvcc`` compiles each source to an object (all started at once),
links them into ``build/repro_torch_kernels/libkernels.so`` at the repo
root, and ``ctypes`` loads it.  The sources expose a plain C interface
(no PyTorch headers), which keeps the build to seconds.  B8's TMA
descriptors are encoded on the host by ``cuTensorMapEncodeTiled``, and
B7's waits are the stream memory operations ``cuStreamWaitValue64`` /
``cuStreamWriteValue*``; ``csrc/flash_attention.cu`` and
``csrc/fused_ring_remote.cu`` reach them through the runtime's
``cudaGetDriverEntryPoint``: the link needs no ``-lcuda``.  Every pointer
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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = [
    "CSRC", "BUILD_DIR", "build", "load", "check", "stream_of", "require_sm90",
    "ptxas_usage", "parse_ptxas",
]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.c_ulonglong
_PI = ctypes.POINTER(ctypes.c_int)
# B5/B6 round: device, vs, scales, ref, out, part, zs, vbar, q1, w, ws, nsn,
# ctr, m, d, r, rows1, splits1, rows2, splits2, ns_iters, grid, group,
# pivot_c, shift_c, form_out, stream.
_ROUND = (_I, *(_P,) * 12, *(_I,) * 10, _F, _F, _P, _P)
# C signature of every entry point: (argtypes), all return an int status.
_SIGNATURES = {
    "rt_gram_f32": (_I, _P, _P, _I, _I, _I, _P),
    "rt_gram_bf16": (_I, _P, _P, _I, _I, _I, _P),
    # device, vs, ref, out, m, d, r, rows, cluster, stream.
    "rt_batched_gram": (_I, _P, _P, _P, *(_I,) * 5, _P),
    # device, cluster, *active.
    "rt_batched_gram_clusters": (_I, _I, _PI),
    # device, vs, ref, g, out, nsn, ctr, m, d, r, rows, cluster, ns_iters,
    # grid, group, form_out, stream.
    "rt_batched_gram_polar": (_I, *(_P,) * 6, *(_I,) * 8, _PI, _P),
    # device, r, *blocks.
    "rt_batched_gram_polar_coresident": (_I, _I, _PI),
    "rt_align_average": (_I, _P, _P, _P, _I, _I, _I, _P),
    "rt_fused_round_f32": _ROUND,
    "rt_fused_round_bf16": _ROUND,
    "rt_fused_round_i8": _ROUND,
    # device, wire (0 f32, 1 bf16, 2 int8), r, *blocks.
    "rt_fused_round_coresident": (_I, _I, _I, _PI),
    # device, bf16_in, q, k, v, o, b, hq, hkv, s, t, hd, causal, window,
    # scale, wait_ns, form_out, stream.
    "rt_flash_attention": (_I, _I, *(_P,) * 4, *(_I,) * 8, _F, _U64, _P, _P),
    "rt_flash_status": (),
    # Test-only: device, wait_ns, stream (a wait that runs out and traps).
    "rt_flash_stall_for_test": (_I, _U64, _P),
    # B7 exchange buffers: alloc (device, bytes, *ptr, handle), open
    # (device, handle, *ptr), close / free (device, ptr).
    "rt_remote_alloc": (_I, ctypes.c_size_t, ctypes.POINTER(_P), _P),
    "rt_remote_open": (_I, _P, ctypes.POINTER(_P)),
    "rt_remote_close": (_I, _P),
    "rt_remote_free": (_I, _P),
    # B7: device, r, *blocks (the hop kernel's co-resident blocks); a hop's
    # waits: device, mine, arrived_want, consumed_want, stream; a hop:
    # device, v, ref, out, part, z, vbar, q1, w, ws, nsn, ctr, mine, right,
    # left, status, seq0, m, d, r, rows1, splits1, rows2, splits2,
    # ns_iters, grid, group, hop, pivot_c, shift_c, stream; the release of
    # a stuck round: device, mine, status, arrived_want, *code.
    "rt_fused_ring_remote_coresident": (_I, _I, _PI),
    "rt_remote_wait": (_I, _P, _U64, _U64, _P),
    "rt_remote_hop": (_I, *(_P,) * 15, _U64, *(_I,) * 11, _F, _F, _P),
    "rt_remote_release": (_I, _P, _P, _U64, _PI),
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


def ptxas_usage(source: str) -> dict[str, dict[str, int]]:
    """Compile ``csrc/<source>`` once more with ``-Xptxas -v`` (into a
    temporary directory) and return, by mangled name, each entry
    function's ``registers``, ``spill_stores`` and ``spill_loads`` (bytes)."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / source),
             "-o", os.path.join(tmp, "ptxas.o")],
            capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{res.stdout}{res.stderr}")
    return parse_ptxas(res.stdout + res.stderr)


def parse_ptxas(log: str) -> dict[str, dict[str, int]]:
    """Registers and spill bytes by entry function from ``-Xptxas -v`` output."""
    usage, name = {}, None
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            name = m.group(1)
            usage[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name]["registers"] = int(m[1])
    return usage


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
    lib.rt_remote_exchange_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rt_remote_exchange_bytes.restype = ctypes.c_size_t
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
