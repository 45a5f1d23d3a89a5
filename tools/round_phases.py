"""Per-phase times of the fused round kernel (B5 and B6) on the card.

    PYTHONPATH=<checkout>/src python3 tools/round_phases.py

Builds ``csrc/fused_round.cu`` of the checkout whose ``src`` is on the
path once more, into a temporary directory under its build directory,
from an edited copy of the sources: every ``grid.sync();`` of
``fused_round.cu`` and ``round_tiles.cuh`` is followed by a stamp (block
0's thread 0 writes ``%globaltimer`` into a small device buffer), the
kernel stamps on entry, and the last block to leave stamps the end.  The
library the port builds has no stamps.  The checkout's own wrappers
(``fused_round``, ``fused_ring_round``) then drive the stamped library at
(m, d, r) = (8, 8192, 128): B5 on an f32 stack and B6 on the f32, bf16 and
int8 wire stacks at the default ring chunk.  For each it prints every
phase's mean time (from one grid barrier to the next) over ``REPS``
launches after a warm-up, their sum, and the launch's time by CUDA events
over the same launches.  Needs a Hopper card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import procrustes_align as pa

M, D, R, REPS = 8, 8192, 128, 20
MAX_STAMPS = 64
# The phases between grid barriers, by how many there are: the one-block
# Newton-Schulz design (9) and the grouped one (11).
LABELS = {
    9: ("Gram partials", "Newton-Schulz", "V-bar", "S1 partials",
        "W1 (block 0: S1 sum, Cholesky, inverse)", "Q1", "S2 partials",
        "W2 (block 0)", "Q"),
    11: ("Gram partials", "Newton-Schulz", "V-bar", "S1 partials", "S1 sum",
         "W1 (block 0: Cholesky, inverse)", "Q1", "S2 partials", "S2 sum",
         "W2 (block 0)", "Q"),
}
PRELUDE = f"""// round_phases.py: phase stamps (not part of the library).
#include <cuda_runtime.h>
__device__ unsigned long long rt_stamps[{MAX_STAMPS}];
__device__ unsigned rt_stamp_n;
__device__ unsigned long long rt_end;
__device__ __forceinline__ unsigned long long rt_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define RT_PHASE_STAMP()                                      \\
  do {{                                                        \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {{                \\
      if (rt_stamp_n < {MAX_STAMPS}) rt_stamps[rt_stamp_n] = rt_now(); \\
      ++rt_stamp_n;                                           \\
    }}                                                         \\
  }} while (0)
struct RtExitStamp {{
  __device__ ~RtExitStamp() {{
    if (threadIdx.x == 0) atomicMax(&rt_end, rt_now());
  }}
}};
extern "C" int rt_phase_read(unsigned long long* stamps, unsigned* n,
                             unsigned long long* end) {{
  cudaError_t err = cudaDeviceSynchronize();
  if (!err) err = cudaMemcpyFromSymbol(stamps, rt_stamps, sizeof(rt_stamps));
  if (!err) err = cudaMemcpyFromSymbol(n, rt_stamp_n, sizeof(unsigned));
  if (!err) err = cudaMemcpyFromSymbol(end, rt_end, sizeof(unsigned long long));
  return static_cast<int>(err);
}}
"""
ENTRY = "cg::grid_group grid = cg::this_grid();"
ENTRY_STAMPED = (ENTRY + "\n  if (blockIdx.x == 0 && threadIdx.x == 0) { rt_stamp_n = 0; rt_end = 0; }"
                 "\n  RT_PHASE_STAMP();\n  RtExitStamp rt_exit_stamp;")


def stamped_sources(dst: Path) -> None:
    """Copy the checkout's csrc into dst with the stamps edited in."""
    for src in _build.CSRC.iterdir():
        (dst / src.name).write_bytes(src.read_bytes())
    kernel = (dst / "fused_round.cu").read_text()
    if kernel.count(ENTRY) != 1:
        raise RuntimeError(f"fused_round.cu: {ENTRY!r} not found once")
    kernel = PRELUDE + kernel.replace(ENTRY, ENTRY_STAMPED)
    for name, text in (("fused_round.cu", kernel),
                       ("round_tiles.cuh", (dst / "round_tiles.cuh").read_text())):
        (dst / name).write_text(text.replace("grid.sync();", "grid.sync(); RT_PHASE_STAMP();"))


def build(tmp: Path) -> ctypes.CDLL:
    """The stamped fused_round.cu and covariance.cu (rt_error_string) in
    one library, compiled at once."""
    stamped_sources(tmp)
    jobs = []
    for name in ("fused_round.cu", "covariance.cu"):
        obj = tmp / f"{name}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(tmp / name), "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for name, _, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the stamped {name}:\n{log}")
    lib_path = tmp / "libphases.so"
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared",
                    *(str(o) for _, o, _ in jobs), "-o", str(lib_path)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    lib.rt_phase_read.restype = ctypes.c_int
    return lib


def phases(lib: ctypes.CDLL, launch) -> tuple[list[float], float, float]:
    """Mean ms of each phase over REPS launches (after one warm-up), their
    sum, and the launches' mean time by CUDA events."""
    stamps = (ctypes.c_ulonglong * MAX_STAMPS)()
    n = ctypes.c_uint(0)
    end = ctypes.c_ulonglong(0)
    launch()
    sums = None
    event_ms = 0.0
    for _ in range(REPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        code = lib.rt_phase_read(stamps, ctypes.byref(n), ctypes.byref(end))
        if code:
            raise RuntimeError(f"rt_phase_read: CUDA error {code}")
        event_ms += start.elapsed_time(stop) / REPS
        t = [*stamps[: n.value], end.value]
        gaps = [(b - a) / 1e6 for a, b in zip(t, t[1:])]
        sums = gaps if sums is None else [s + g for s, g in zip(sums, gaps)]
    mean = [s / REPS for s in sums]
    return mean, sum(mean), event_ms


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.require_sm90(torch.empty(0, device=dev))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    print(f"[tree] {_build.CSRC}")
    g = torch.Generator(device=dev).manual_seed(0)
    base = torch.linalg.qr(torch.randn(D, R, generator=g, device=dev))[0]
    noise = torch.randn(M, D, R, generator=g, device=dev) * (0.1 / math.sqrt(D))
    vs = torch.linalg.qr(base[None] + noise)[0].contiguous()
    rf = vs[0].contiguous()
    scales = (vs.abs().amax(dim=1) / 127.0).contiguous()
    q8 = torch.clamp(torch.round(vs / scales[:, None, :]), -127, 127).to(torch.int8)
    cases = {
        "B5 fused_round f32": lambda: pa.fused_round(vs, rf),
        "B6 fused_ring_round f32": lambda: pa.fused_ring_round(vs, rf),
        "B6 fused_ring_round bf16": lambda: pa.fused_ring_round(vs.to(torch.bfloat16), rf),
        "B6 fused_ring_round int8": lambda: pa.fused_ring_round(q8, rf, scales),
    }
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        lib = build(Path(tmp))
        _build.load = lambda: lib  # the wrappers look the library up at each call
        for name, launch in cases.items():
            mean, total, event_ms = phases(lib, launch)
            labels = LABELS.get(len(mean), tuple(f"phase {k + 1}" for k in range(len(mean))))
            form = getattr(pa.fused_round if name.startswith("B5") else pa.fused_ring_round,
                           "last_form", None)
            print(f"[phases] {name} at ({M}, {D}, {R}): grid "
                  f"{(pa.fused_round if name.startswith('B5') else pa.fused_ring_round).grid}"
                  f"{'' if form is None else f', Newton-Schulz {form}'}")
            for k, (label, ms) in enumerate(zip(labels, mean)):
                print(f"[phases]   {k + 1:>2} {label:<42} {ms:.4f} ms")
            print(f"[phases]   sum of phases {total:.4f} ms; launch by CUDA events "
                  f"{event_ms:.4f} ms (mean of {REPS})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
