#!/usr/bin/env python3
"""Where the CCL block body's time goes, phase by phase, CTA by CTA, on one
card.

Builds a copy of ``aruco_slam_tpu_torch/ops/kernels/csrc/ccl.cu`` with
``%globaltimer`` marks (the card's nanosecond clock, one for every SM) at
each team barrier's arrival and release and inside each label round and
the threshold (thread 0 of every CTA of the first team, its first frame),
runs K3 (``threshold_label_union``) and K5 (``label_components``, on K3's
raw mask) through the port's wrappers on rendered 1920x1080 frames, and
prints for each segment between two marks the median and the largest time
over the team's CTAs, and which tile took the largest. A ``wait`` segment
is a barrier's: the time from a CTA's arrival to its release, that is how
long the slowest tile kept it waiting. The labels are checked against the
plain version, so the marks change no result. Its marks anchor on lines
of ``csrc/ccl.cu`` and ``csrc/grid_barrier.cuh``: edit them together.
Needs one CUDA card and nvcc.

    python3 tools/ccl_block_stages.py [FRAMES]   (default 1)
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MAX_CTAS, MAX_MARKS = 132, 64
PRELUDE = """
__device__ unsigned long long g_marks[%d * %d];
__device__ int g_count[%d];
// a mark: the global timer in the high bits, the tag in the low 4
__device__ __forceinline__ void mark(int tag) {
  if (threadIdx.x == 0 && blockIdx.x < %d && g_count[blockIdx.x] < %d) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
    g_marks[blockIdx.x * %d + g_count[blockIdx.x]++] = (t << 4) | tag;
  }
}
""" % (MAX_CTAS, MAX_MARKS, MAX_CTAS, MAX_CTAS, MAX_MARKS, MAX_MARKS)
READER = """
extern "C" int ccl_marks(unsigned long long* out, int* count) {
  cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
  cudaMemcpyFromSymbol(count, g_count, sizeof(g_count));
  int zero[%d] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_count, zero, sizeof(zero)));
}
""" % MAX_CTAS
TAGS = {0: "start", 1: "run", 2: "wait", 3: "halo", 4: "jacobi", 5: "row scans",
        6: "cell means", 7: "mask ring", 8: "dilate", 9: "erode", 10: "column scans"}
# (anchor in ccl.cu, tag of the mark after it); tag 4 goes before its anchor
MARKS = [
    ("  for (int f = team; f < g.n; f += g.teams) {\n", 0),
    ("  __syncthreads();\n  // ---- the Jacobi 8-neighbour min", 3),
    ("  // ---- row scans, forward then backward (each horizontal", 4),
    ("  __syncthreads();\n  if (T.TX > 1) {  // each row's left-", 5),
    ("    mean[c] = acc / area;\n  }\n  __syncthreads();\n", 6),
    ("      fill_ring(a.fg, T, T.mask(L.fgb, 2), 2);\n      __syncthreads();\n", 7),
    ("    d[yy * MW + kk] = acc;\n  }\n  __syncthreads();\n", 8),
    ("    c[yy * MW + kk] = acc & in_frame_bits(T, kk);\n  }\n  __syncthreads();\n", 9),
    ("    top[x] = t_run | f;\n    bot[x] = b_run | f;\n  }\n  __syncthreads();\n", 10),
]


def marked_source(csrc: Path) -> str:
    """ccl.cu with the barrier header inlined and the marks in place."""
    src = (csrc / "ccl.cu").read_text()
    hdr = (csrc / "grid_barrier.cuh").read_text().replace("#pragma once", "")
    enter = "  __syncthreads();\n  if (threadIdx.x == 0) {\n"
    leave = "    __threadfence();\n  }\n  __syncthreads();\n}"
    for anchor in (enter, leave):
        if hdr.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in grid_barrier.cuh: {anchor!r}")
    hdr = hdr.replace(enter, "  __syncthreads();\n  mark(1);\n  if (threadIdx.x == 0) {\n")
    hdr = hdr.replace(leave, "    __threadfence();\n  }\n  mark(2);\n  __syncthreads();\n}")
    include = '#include "grid_barrier.cuh"\n'
    for anchor, _ in [(include, None)] + MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ccl.cu: {anchor!r}")
    src = src.replace(include, PRELUDE + hdr)
    for anchor, tag in MARKS:
        if tag == 4:
            src = src.replace(anchor, f"  mark({tag});\n" + anchor)
        elif tag in (3, 5):  # after the anchor's first line
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, first + f"\n  mark({tag});\n" + rest)
        else:
            src = src.replace(anchor, anchor + f"  mark({tag});\n")
    return src + READER


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import _build, ccl

    if not torch.cuda.is_available():
        print("ccl_block_stages: needs a CUDA card", file=sys.stderr)
        return 2
    frames = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ccl.cu"
        src.write_text(marked_source(_build.CSRC))
        _build._compile(src, Path(tmp) / "ccl.so")
        lib = ctypes.CDLL(str(Path(tmp) / "ccl.so"))
    lib.ccl_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _build._loaded["ccl"] = lib  # the wrappers launch the marked build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = DetectorConfig()
    r, C, s, r1, r2 = (cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds,
                       cfg.closed_ccl_rounds)
    img = cs._render_hd(frames, dev)
    ref = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
    marks = np.zeros(MAX_CTAS * MAX_MARKS, np.uint64)
    count = np.zeros(MAX_CTAS, np.int32)
    plan = ccl.block_plan(1080, 1920, frames)
    calls = {"K3": (lambda: ccl.threshold_label_union(img, r, C, s, r1, r2), ref),
             "K5": (lambda: (ccl.label_components(ref[0], r1),),
                    (ccl.label_components_reference(ref[0], r1),))}
    for name, (call, want) in calls.items():
        for _ in range(2):  # the second launch is read: the first builds the plan
            got = call()
            torch.cuda.synchronize()
            lib.ccl_marks(marks.ctypes.data, count.ctypes.data)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{name}: the marked build differs from the plain version")
        n = int(count[:plan.ctas].min())
        raw = marks.reshape(MAX_CTAS, MAX_MARKS)[:plan.ctas, :n]
        t = (raw >> np.uint64(4)).astype(np.int64)
        tags = (raw & np.uint64(15)).astype(int)
        seg = np.diff(t, axis=1) / 1e3
        print(f"{name} on {frames} 1920x1080 frame(s): tiles of {plan.tile_rows} rows, "
              f"{plan.ctas} CTAs a team, {plan.teams} team(s); the first team's first frame, "
              f"{(t[:, -1].max() - t[:, 0].min()) / 1e3:.1f} us in all")
        for i in range(seg.shape[1]):
            print(f"  {i:2d} {TAGS[tags[0, i + 1]]:13s} median {np.median(seg[:, i]):6.1f} us, "
                  f"largest {seg[:, i].max():6.1f} us (tile {seg[:, i].argmax()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
