"""Per-phase times of the round kernels (B5, B6), B3's Newton-Schulz pass
and B7's hops on the card.

    PYTHONPATH=<checkout>/src python3 tools/round_phases.py

Builds the kernels of the checkout whose ``src`` is on the path once more,
into a temporary directory under its build directory, from an edited copy
of the sources: every ``grid.sync();`` of ``fused_round.cu``,
``fused_ring_remote.cu`` and ``round_tiles.cuh`` is followed by a stamp
(block 0's thread 0 writes ``%globaltimer`` into a small device buffer),
each stamped kernel stamps on entry, and the last block of a launch to
leave stamps its end.  The library the port builds has no stamps.  The
checkout's own wrappers then drive the stamped library:

* B5 on an f32 stack and B6 on the f32, bf16 and int8 wire stacks at
  (m, d, r) = (8, 8192, 128) and the default ring chunk: every phase's
  mean time (from one stamp to the next) over ``REPS`` launches after a
  warm-up, their sum, and the launch's time by CUDA events;
* B3 at (8, 8192, 128), 192 and 256: its launch by CUDA events, its
  Newton-Schulz pass (entry to the last block's end, by the stamps) and
  B2 alone (its first pass) by CUDA events;
* B7 in a world of ``WORLD`` rank processes sharing the card, (8192, 128)
  a rank: per hop the wait (from the previous hop's end to this one's
  start; in a persistent kernel, to the grid barrier after the wait), the
  push and Gram, the polar step and the apply, then the tail, and the
  round by CUDA events, the slowest rank's.  Where the checkout's B7
  waits between launches as stream memory operations (``wait_word``),
  the same rounds run with a second library in which ``wait_word``
  launches a one-block kernel that spins on the word instead (the spin
  form, which exists only here), in turns: stream, spin, spin, stream.

Needs a Hopper card and ``nvcc``.  Run it on two checkouts in one call to
compare them (``build/parent/src`` and ``src``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import procrustes_align as pa

M, D, R, REPS = 8, 8192, 128, 20
B3_RS = (128, 192, 256)
WORLD, B7_REPS = 8, 10
MAX_STAMPS = 128
# The stamped kernels of each source (a name missing from a checkout is
# skipped): its entry, and its end by the last block to leave.
KERNELS = {
    "fused_round.cu": ("fused_round_kernel",),
    "procrustes_align.cu": ("ns_polar_kernel", "ns_group_kernel"),
    "fused_ring_remote.cu": ("fused_ring_remote_kernel", "remote_hop_kernel"),
}
SYNCED = ("fused_round.cu", "fused_ring_remote.cu", "round_tiles.cuh")
# B5/B6's phases between stamps, by how many there are: the one-block
# Newton-Schulz design (9) and the grouped one (11).
LABELS = {
    9: ("Gram partials", "Newton-Schulz", "V-bar", "S1 partials",
        "W1 (block 0: S1 sum, Cholesky, inverse)", "Q1", "S2 partials",
        "W2 (block 0)", "Q"),
    11: ("Gram partials", "Newton-Schulz", "V-bar", "S1 partials", "S1 sum",
         "W1 (block 0: Cholesky, inverse)", "Q1", "S2 partials", "S2 sum",
         "W2 (block 0)", "Q"),
}
TAIL_SYNCS = 7  # grid barriers of round_tiles.cuh's cholqr2_tail
PRELUDE = f"""// round_phases.py: phase stamps (not part of the library).
#include <cuda_runtime.h>
static __device__ unsigned long long rt_stamps[{MAX_STAMPS}];
static __device__ unsigned rt_stamp_n;
static __device__ unsigned rt_left;
static __device__ __forceinline__ unsigned long long rt_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
static __device__ __forceinline__ void rt_stamp() {{
  const unsigned k = atomicAdd(&rt_stamp_n, 1u);
  if (k < {MAX_STAMPS}) rt_stamps[k] = rt_now();
}}
#define RT_PHASE_STAMP()                                         \\
  do {{                                                           \\
    if (blockIdx.x == 0 && threadIdx.x == 0) rt_stamp();          \\
  }} while (0)
struct RtExitStamp {{
  __device__ ~RtExitStamp() {{
    if (threadIdx.x == 0) {{
      __threadfence();
      if (atomicAdd(&rt_left, 1u) + 1 == gridDim.x) {{
        rt_left = 0;
        rt_stamp();
      }}
    }}
  }}
}};
extern "C" int rt_phase_read_TAG(unsigned long long* stamps, unsigned* n) {{
  cudaError_t err = cudaDeviceSynchronize();
  if (!err) err = cudaMemcpyFromSymbol(stamps, rt_stamps, sizeof(rt_stamps));
  if (!err) err = cudaMemcpyFromSymbol(n, rt_stamp_n, sizeof(unsigned));
  const unsigned zero = 0;
  if (!err) err = cudaMemcpyToSymbol(rt_stamp_n, &zero, sizeof(unsigned));
  return static_cast<int>(err);
}}
"""
SPIN = """// round_phases.py: the spin form of B7's wait (not part of the library).
__global__ void rt_spin_wait_kernel(const unsigned long long* p,
                                    unsigned long long want) {
  if (threadIdx.x) return;
  const unsigned long long t0 = rt_now();
  unsigned long long v;
  do {
    asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    if (v >= want) return;
    __nanosleep(200);
  } while (rt_now() - t0 < 60000000000ull);
}
int wait_word(cudaStream_t s, const void* p, u64 want) {
  rt_spin_wait_kernel<<<1, 32, 0, s>>>(static_cast<const unsigned long long*>(p), want);
  return static_cast<int>(cudaGetLastError());
}
"""
WAIT_WORD = re.compile(r"int wait_word\(cudaStream_t s, const void\* p, u64 want\) \{.*?\n\}\n",
                       re.S)


def stamp_kernel(text: str, name: str) -> str:
    """Stamp the entry and the end of kernel ``name`` (if defined)."""
    m = re.search(rf"\b{name}\([^;{{]*\)\s*\{{", text)
    if not m:
        return text
    return (text[:m.end()] + "\n  RT_PHASE_STAMP();\n  RtExitStamp rt_exit_stamp;"
            + text[m.end():])


def stamped_sources(dst: Path, spin: bool = False) -> bool:
    """Copy the checkout's csrc into dst with the stamps edited in (and,
    when spin, B7's wait_word replaced by the spin kernel's launch);
    returns whether the checkout has a wait_word to replace."""
    for src in _build.CSRC.iterdir():
        (dst / src.name).write_bytes(src.read_bytes())
    has_wait = False
    for name in SYNCED:
        text = (dst / name).read_text()
        (dst / name).write_text(text.replace("grid.sync();", "grid.sync(); RT_PHASE_STAMP();"))
    for name, kernels in KERNELS.items():
        text = (dst / name).read_text()
        for kernel in kernels:
            text = stamp_kernel(text, kernel)
        text = PRELUDE.replace("TAG", Path(name).stem) + text
        if name == "fused_ring_remote.cu":
            has_wait = bool(WAIT_WORD.search(text))
            if spin and has_wait:
                text = WAIT_WORD.sub(lambda _: SPIN, text)
        (dst / name).write_text(text)
    return has_wait


def compile_objects(tmp: Path, names) -> dict:
    """nvcc every source of names in tmp at once; their objects by name."""
    jobs = []
    for name in names:
        obj = tmp / f"{name}.o"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", str(tmp / name), "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    for name, _, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the stamped {tmp / name}:\n{log}")
    return {name: obj for name, obj, _ in jobs}


def link(objs, path: Path) -> Path:
    subprocess.run([_build._nvcc(), *_build.ARCH_FLAGS, "-shared", *map(str, objs),
                    "-o", str(path)], check=True)
    return path


def build(tmp: Path) -> tuple[Path, Path | None]:
    """The stamped library (fused_round.cu, procrustes_align.cu,
    fused_ring_remote.cu and covariance.cu for rt_error_string), and the
    spin form's B7 library when the checkout waits between launches (else
    None); every object compiled at once."""
    main, spin = tmp / "main", tmp / "spin"
    main.mkdir()
    spin.mkdir()
    names = (*KERNELS, "covariance.cu")
    stamped_sources(main)
    has_wait = stamped_sources(spin, spin=True)
    objs = compile_objects(main, names)
    spin_objs = compile_objects(spin, ("fused_ring_remote.cu",)) if has_wait else None
    lib = link(objs.values(), tmp / "libphases.so")
    if not has_wait:
        return lib, None
    return lib, link([spin_objs["fused_ring_remote.cu"], objs["covariance.cu"]],
                     tmp / "libspin.so")


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _build._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "rt_remote_exchange_bytes"):
        lib.rt_remote_exchange_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.rt_remote_exchange_bytes.restype = ctypes.c_size_t
    return lib


def read_stamps(lib: ctypes.CDLL, tag: str) -> list[int]:
    """The stamps of source tag since the last read (synchronises)."""
    stamps = (ctypes.c_ulonglong * MAX_STAMPS)()
    n = ctypes.c_uint(0)
    code = getattr(lib, f"rt_phase_read_{tag}")(stamps, ctypes.byref(n))
    if code:
        raise RuntimeError(f"rt_phase_read_{tag}: CUDA error {code}")
    if n.value > MAX_STAMPS:
        raise RuntimeError(f"{n.value} stamps, more than {MAX_STAMPS}")
    return list(stamps[: n.value])


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phases(lib: ctypes.CDLL, launch) -> tuple[list[float], float, float]:
    """B5/B6: mean ms of each phase over REPS launches (after one warm-up),
    their sum, and the launches' mean time by CUDA events."""
    launch()
    read_stamps(lib, "fused_round")
    sums = None
    ms = 0.0
    for _ in range(REPS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        t = read_stamps(lib, "fused_round")
        ms += start.elapsed_time(stop) / REPS
        gaps = [(b - a) / 1e6 for a, b in zip(t, t[1:])]
        sums = gaps if sums is None else [s + g for s, g in zip(sums, gaps)]
    mean = [s / REPS for s in sums]
    return mean, sum(mean), ms


def noisy_stack(m, d, r, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.linalg.qr(torch.randn(d, r, generator=g, device=dev))[0]
    noise = torch.randn(m, d, r, generator=g, device=dev) * (0.1 / math.sqrt(d))
    return torch.linalg.qr(base[None] + noise)[0].contiguous()


def rounds_b5_b6(lib, dev) -> None:
    vs = noisy_stack(M, D, R, dev)
    rf = vs[0].contiguous()
    scales = (vs.abs().amax(dim=1) / 127.0).contiguous()
    q8 = torch.clamp(torch.round(vs / scales[:, None, :]), -127, 127).to(torch.int8)
    cases = {
        "B5 fused_round f32": (pa.fused_round, lambda: pa.fused_round(vs, rf)),
        "B6 fused_ring_round f32": (pa.fused_ring_round, lambda: pa.fused_ring_round(vs, rf)),
        "B6 fused_ring_round bf16": (pa.fused_ring_round,
                                     lambda: pa.fused_ring_round(vs.to(torch.bfloat16), rf)),
        "B6 fused_ring_round int8": (pa.fused_ring_round,
                                     lambda: pa.fused_ring_round(q8, rf, scales)),
    }
    for name, (wrapper, launch) in cases.items():
        mean, total, ms = phases(lib, launch)
        labels = LABELS.get(len(mean), tuple(f"phase {k + 1}" for k in range(len(mean))))
        form = getattr(wrapper, "last_form", None)
        print(f"[phases] {name} at ({M}, {D}, {R}): grid {wrapper.grid}"
              f"{'' if form is None else f', Newton-Schulz {form}'}")
        for k, (label, t) in enumerate(zip(labels, mean)):
            print(f"[phases]   {k + 1:>2} {label:<42} {t:.4f} ms")
        print(f"[phases]   sum of phases {total:.4f} ms; launch by CUDA events "
              f"{ms:.4f} ms (mean of {REPS})")


def newton_schulz_b3(lib, dev) -> None:
    """B3's launch, its Newton-Schulz pass by the stamps, B2 alone."""
    for r in B3_RS:
        vs = noisy_stack(M, D, r, dev)
        rf = vs[0].contiguous()
        total = event_ms(lambda: pa.batched_gram_polar(vs, rf), REPS)
        read_stamps(lib, "procrustes_align")
        ns = 0.0
        for _ in range(REPS):
            pa.batched_gram_polar(vs, rf)
            t = read_stamps(lib, "procrustes_align")
            ns += (t[-1] - t[0]) / 1e6 / REPS
        b2 = event_ms(lambda: pa.batched_gram(vs, rf), REPS)
        form = getattr(pa.batched_gram_polar, "last_form", None)
        print(f"[b3] batched_gram_polar ({M}, {D}, {r}): launch {total:.4f} ms by CUDA "
              f"events; Newton-Schulz pass {ns:.4f} ms (entry to the last block's end, "
              f"stamps){'' if form is None else f', {form}'}; B2 alone {b2:.4f} ms "
              f"(mean of {REPS})")


def hop_phases(t: list[int], m: int, per_launch: bool) -> dict:
    """One B7 round's stamps into per-hop (wait, push + Gram, polar,
    apply) ms and the tail's.  per_launch: a launch a hop (entry, three
    barriers, end; the last hop's tail barriers before its end), else one
    persistent launch (entry, four barriers a hop, the tail's, end)."""
    ms = [x / 1e6 for x in t]
    hops = []
    if per_launch:
        k, prev_end = 0, None
        for i in range(m):
            entry, s1, s2, s3 = ms[k:k + 4]
            k += 4 + (TAIL_SYNCS if i == m - 1 else 0)
            end = ms[k]
            k += 1
            hops.append({"wait": None if prev_end is None else entry - prev_end,
                         "gram": s1 - entry, "polar": s2 - s1, "apply": s3 - s2})
            prev_end = end
        tail = end - s3
    else:
        prev = ms[0]
        for i in range(m):
            w, g, p, a = ms[1 + 4 * i:5 + 4 * i]
            hops.append({"wait": w - prev, "gram": g - w, "polar": p - g, "apply": a - p})
            prev = a
        tail = ms[-1] - prev
    return {"hops": hops, "tail": tail}


def rank_worker(rank: int, init: str, libs: list[str], out: str) -> int:
    """One rank of the B7 world: B7_REPS rounds with each library of libs
    in turn (after a warm-up round each), stamps read after every round."""
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    vs = noisy_stack(WORLD, D, R, dev, seed=1)
    v, rf = vs[rank].contiguous(), vs[0].contiguous()
    loaded = {p: load(Path(p)) for p in dict.fromkeys(libs)}
    text = (_build.CSRC / "fused_ring_remote.cu").read_text()
    per_launch = bool(WAIT_WORD.search(text))
    report = []
    for path in libs:
        lib = loaded[path]
        _build.load = lambda lib=lib: lib
        rounds = []
        for k in range(B7_REPS + 1):
            dist.barrier()
            torch.cuda.synchronize()
            read_stamps(lib, "fused_ring_remote")
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            pa.fused_ring_round_remote(v, rf, group=None)
            stop.record()
            t = read_stamps(lib, "fused_ring_remote")
            if k == 0:
                continue  # warm-up
            cell = hop_phases(t, WORLD, per_launch)
            cell["ms"] = start.elapsed_time(stop)
            cell["events"] = list(getattr(pa.fused_ring_round_remote, "last_hops", []))
            rounds.append(cell)
        report.append({"lib": path, "rounds": rounds})
    dist.barrier()
    pa.close_remote(None)
    dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump({"per_launch": per_launch, "runs": report}, f)
    return 0


def mean(xs) -> float:
    xs = [x for x in xs if x is not None]
    return sum(xs) / len(xs) if xs else float("nan")


def remote_b7(lib_path: Path, spin_path: Path | None) -> None:
    """B7 in a world of WORLD rank processes on this card."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    forms = {str(lib_path): "stream-wait" if spin_path else "persistent (spin)"}
    libs = [str(lib_path)]
    if spin_path is not None:
        forms[str(spin_path)] = "spin (tool only)"
        libs = [str(lib_path), str(spin_path), str(spin_path), str(lib_path)]
    with tempfile.TemporaryDirectory() as out:
        env = {**os.environ}
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(k), "--init", init,
             "--libs", ",".join(libs), "--out", out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(k, p.returncode, logs[k][-2000:]) for k, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"B7 rank workers failed: {bad}")
        reports = [json.load(open(os.path.join(out, f"rank{k}.json"))) for k in range(WORLD)]
    for j, path in enumerate(libs):
        runs = [rep["runs"][j]["rounds"] for rep in reports]
        slowest = mean(max(rk[i]["ms"] for rk in runs) for i in range(B7_REPS))
        cells = [c for rk in runs for c in rk]
        hops = [h for c in cells for h in c["hops"]]
        waits = [h["wait"] for h in hops]
        print(f"[b7] run {j + 1}, {forms[path]} ({WORLD} ranks sharing the card, ({D}, {R}) "
              f"a rank, {B7_REPS} rounds): round {slowest:.4f} ms (slowest rank by CUDA "
              f"events, mean over rounds); per hop, mean over ranks and hops: wait "
              f"{mean(waits):.4f} ms (max {max(w for w in waits if w is not None):.4f}), "
              f"push + Gram {mean(h['gram'] for h in hops):.4f}, polar step "
              f"{mean(h['polar'] for h in hops):.4f} (max {max(h['polar'] for h in hops):.4f}), "
              f"apply {mean(h['apply'] for h in hops):.4f}; tail "
              f"{mean(c['tail'] for c in cells):.4f} ms (stamps)")
        ev = [e for c in cells for e in c["events"]]
        if ev:
            print(f"[b7]   by the wrapper's events: per hop wait {mean(w for w, _ in ev):.4f} ms, "
                  f"compute {mean(c for _, c in ev):.4f} ms; a round's waits "
                  f"{mean(sum(w for w, _ in c['events']) for c in cells):.4f} ms, compute "
                  f"{mean(sum(x for _, x in c['events']) for c in cells):.4f} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--libs", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.rank is not None:
        return rank_worker(args.rank, args.init, args.libs.split(","), args.out)
    dev = torch.device("cuda", 0)
    _build.require_sm90(torch.empty(0, device=dev))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    print(f"[tree] {_build.CSRC}")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        lib_path, spin_path = build(Path(tmp))
        print(f"[build] stamped libraries in {time.perf_counter() - t0:.1f} s")
        lib = load(lib_path)
        _build.load = lambda: lib  # the wrappers look the library up at each call
        rounds_b5_b6(lib, dev)
        newton_schulz_b3(lib, dev)
        remote_b7(lib_path, spin_path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
