"""Time variants of the B1 Gram kernel's slice depth, ring depth and
occupancy on the card, against the kernel as it ships.

    PYTHONPATH=src python3 tools/gram_variants.py

Builds ``csrc/covariance.cu`` as it stands and once for each variant in
``VARIANTS`` (a change of its ``kBK`` rows a slice, its ``kStages`` ring
stages, or one block an SM instead of two), all ``nvcc`` jobs at once,
into a temporary directory under the build directory.  For each it prints
ptxas's registers and spill bytes for the f32 kernel, its time at one
shard of the production width, (65536, 8192) f32 (CUDA events, warm L2,
the mean of 3 launches after one warm-up), and whether its output has the
shipped kernel's bits.  The shipped kernel is timed first and again last,
and ``x.T @ x`` beside them.  Needs a Hopper card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.kernels import _build

N, D = 65536, 8192
SHIPPED = "shipped: 32 rows, 3 stages"
VARIANTS = {
    SHIPPED: {},
    "16 rows, 3 stages": {"kBK = 32;": "kBK = 16;"},
    "16 rows, 4 stages": {"kBK = 32;": "kBK = 16;", "kStages = 3;": "kStages = 4;"},
    "16 rows, 5 stages": {"kBK = 32;": "kBK = 16;", "kStages = 3;": "kStages = 5;"},
    "32 rows, 2 stages": {"kStages = 3;": "kStages = 2;"},
    "one block an SM": {"__launch_bounds__(kThreads, 2)": "__launch_bounds__(kThreads, 1)"},
}
F32_KERNEL = "gram_kernelIfLb1E"  # gram_kernel<float, true>: 16-byte copies


def build_all(tmp: Path) -> dict[str, tuple[ctypes.CDLL, dict[str, int]]]:
    """Compile every variant at once; return its library and f32 ptxas usage."""
    base = (_build.CSRC / "covariance.cu").read_text()
    common = (_build.CSRC / "common.cuh").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        src = base
        for old, new in edits.items():
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: {old!r} not found once in covariance.cu")
            src = src.replace(old, new)
        d = tmp / str(len(jobs))
        d.mkdir()
        (d / "covariance.cu").write_text(src)
        (d / "common.cuh").write_text(common)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
               str(d / "covariance.cu"), "-o", str(d / "lib.so")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (d, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{log}")
        usage = next(u for k, u in _build.parse_ptxas(log).items() if F32_KERNEL in k)
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.rt_gram_f32.argtypes = list(_build._SIGNATURES["rt_gram_f32"])
        lib.rt_gram_f32.restype = ctypes.c_int
        built[name] = (lib, usage)
    return built


def time_ms(fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.require_sm90(torch.empty(0, device=dev))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        built = build_all(Path(tmp))
        x = torch.randn(N, D, generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        out = torch.empty(D, D, device=dev)

        def run(lib):
            code = lib.rt_gram_f32(0, x.data_ptr(), out.data_ptr(), 1, N, D,
                                   _build.stream_of(x))
            if code:
                raise RuntimeError(f"rt_gram_f32: CUDA error {code}")
            return out

        want = run(built[SHIPPED][0]).clone()
        for name in [*VARIANTS, SHIPPED]:
            lib, use = built[name]
            same = torch.equal(run(lib), want)
            ms = time_ms(lambda: run(lib))
            print(f"[variant] {name:<28} {use['registers']} registers, spill stores "
                  f"{use['spill_stores']} B: {ms:.3f} ms, "
                  f"{N * D * (D + 1) / (ms * 1e9):.2f} TFLOP/s of n d (d + 1), "
                  f"shipped bits {same}")
        print(f"[variant] x.T @ x {time_ms(lambda: x.T @ x):.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
