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
long the slowest tile kept it waiting. The threshold's segments: the
staged read (the tile's pixels copied into shared memory), the block means
(the ``run`` up to the team barrier), the barrier's ``wait``, the window
sums, the window means and the comparison (fg and mask words written).
With ``--p3`` it runs instead K4 (3 rounds, the probes' threshold) on P3's
1920x1080 frame of random bytes in the planner's resident plan and in
``ccl.spilled_plan``, and reads the team's CTAs that hold a tile; with
``--p1a`` P1a (``threshold_only``, the probes' threshold) on
chip_smoke.py's 16 1920x1080 float32 probe frames, every frame of the first
team (two teams of eight frames on an H100). ``TREE`` (default: this
checkout) is the root of the checkout whose port, kernel source and
``chip_smoke.py`` run, so that two trees compare on one card; the marks
whose anchor lines another tree's source lacks are left out and named
(this tree's source must hold every anchor; the barrier's marks are in
both). Every output is checked against the plain version, so the marks
change no result. Its marks anchor on lines of ``csrc/ccl.cu`` and
``csrc/grid_barrier.cuh``: edit them together. The last line is a JSON
object of every segment. Needs one CUDA card and nvcc.

    python3 tools/ccl_block_stages.py [FRAMES [TREE]]   (default 1)
    python3 tools/ccl_block_stages.py --p3 [TREE]
    python3 tools/ccl_block_stages.py --p1a [TREE]
"""

import ctypes
import json
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
        6: "window means", 7: "mask ring", 8: "dilate", 9: "erode", 10: "column scans",
        11: "staged read", 12: "window sums", 13: "comparison"}
# (anchor in ccl.cu, tag of the mark after it); tag 4 goes before its anchor
MARKS = [
    ("  for (int f = team; f < g.n; f += g.teams) {\n", 0),
    ("  __syncthreads();\n  // ---- the Jacobi 8-neighbour min", 3),
    ("  // ---- row scans, forward then backward (each horizontal", 4),
    ("  __syncthreads();\n  if (T.TX > 1) {  // each row's left-", 5),
    ("      thr_stage<P>(a, T.px, T.y0, T.x0, T.rows, T.cols, st, T.TW);\n      __syncthreads();\n",
     11),
    ("V[(j0 + j) * c.vw + p.x] = acc[j];\n    }\n    __syncthreads();\n", 12),
    ("    __syncthreads();\n    thr_compare<P, kStaged, kFg32>(", 6),
    ("    __syncthreads();  // the chunk's sums and means are read before the next overwrites them\n",
     13),
    ("      fill_ring(a.fg, T, T.mask(L.fgb, 2), 2);\n      __syncthreads();\n", 7),
    ("    d[yy * MW + kk] = acc;\n  }\n  __syncthreads();\n", 8),
    ("    c[yy * MW + kk] = acc & in_frame_bits(T, kk);\n  }\n  __syncthreads();\n", 9),
    ("    top[x] = t_run | f;\n    bot[x] = b_run | f;\n  }\n  __syncthreads();\n", 10),
]

def marked_source(csrc: Path, strict: bool = True) -> str:
    """ccl.cu with the barrier header inlined and the marks in place.
    ``strict``: every anchor must be found once; else a mark whose anchor
    is missing is left out."""
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
    if src.count(include) != 1:
        raise SystemExit(f"anchor not found once in ccl.cu: {include!r}")
    src = src.replace(include, PRELUDE + hdr)
    for anchor, tag in MARKS:
        if src.count(anchor) != 1:
            if strict or src.count(anchor) > 1:
                raise SystemExit(f"anchor not found once in ccl.cu: {anchor!r}")
            print(f"(no mark '{TAGS[tag]}' in {csrc}: its anchor is not in that source)")
            continue
        if tag == 4:
            src = src.replace(anchor, f"  mark({tag});\n" + anchor)
        elif tag in (3, 5, 6):  # after the anchor's first line
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, first + f"\n  mark({tag});\n" + rest)
        else:
            src = src.replace(anchor, anchor + f"  mark({tag});\n")
    return src + READER


def _segments(name, plan, marks, count, what):
    """Prints and returns the segments of the first team's CTAs that hold a
    tile (ranks below the frame's tiles)."""
    import numpy as np

    ctas = min(plan.ctas, plan.tiles_x * plan.tiles_y)
    n = int(count[:ctas].min())
    raw = marks.reshape(MAX_CTAS, MAX_MARKS)[:ctas, :n]
    t = (raw >> np.uint64(4)).astype(np.int64)
    tags = (raw & np.uint64(15)).astype(int)
    seg = np.diff(t, axis=1) / 1e3
    total = (t[:, -1].max() - t[:, 0].min()) / 1e3
    print(f"{name} on {what}: tiles of {plan.tile_rows}x{plan.tile_width}, "
          f"{plan.tiles_x * plan.tiles_y} a frame, {plan.ctas} CTAs a team "
          f"({'spilled' if plan.spilled else 'resident'}), {plan.teams} team(s); the first "
          f"team's frames in turn, {total:.1f} us in all")
    rows = []
    for i in range(seg.shape[1]):
        rows.append({"tag": TAGS[tags[0, i + 1]], "median_us": float(np.median(seg[:, i])),
                     "largest_us": float(seg[:, i].max()), "tile": int(seg[:, i].argmax())})
        print(f"  {i:2d} {rows[-1]['tag']:13s} median {rows[-1]['median_us']:6.1f} us, "
              f"largest {rows[-1]['largest_us']:6.1f} us (tile {rows[-1]['tile']})")
    waits = sum(r["median_us"] for r in rows if r["tag"] == "wait")
    print(f"  barrier waits (medians) {waits:.1f} us of {total:.1f}")
    return {"plan": plan._asdict(), "total_us": float(total), "wait_us": float(waits),
            "segments": rows}


def main() -> int:
    import numpy as np
    import torch

    args = sys.argv[1:]
    mode, tree = None, ROOT
    if args[:1] in (["--p3"], ["--p1a"]):
        mode, args = args[0], args[1:]
    trees = args[1:] if mode is None else args  # [FRAMES [TREE]] or [TREE]
    if trees:
        tree = Path(trees[0]).resolve()
        sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import _build, ccl

    if not torch.cuda.is_available():
        print("ccl_block_stages: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"kernel source: {_build.CSRC}")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ccl.cu"
        src.write_text(marked_source(_build.CSRC, strict=tree == ROOT))
        _build._compile(src, Path(tmp) / "ccl.so")
        lib = ctypes.CDLL(str(Path(tmp) / "ccl.so"))
    lib.ccl_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    _build._loaded["ccl"] = lib  # the wrappers launch the marked build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    marks = np.zeros(MAX_CTAS * MAX_MARKS, np.uint64)
    count = np.zeros(MAX_CTAS, np.int32)
    if mode == "--p3":
        r, C, s, n = cs.PROBE_RADIUS, cs.PROBE_C, cs.PROBE_STRIDE, cs.P3_ROUNDS
        img = cs._probe_frames(dev)["p3"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plans = {"resident": ccl.block_plan(1080, 1920, 1, sms),
                 "spilled": ccl.spilled_plan(1080, 1920, sms)}
        ref = ccl.threshold_label_reference(img, r, C, s, n)
        calls = {f"K4 {kind}": (lambda p=p: ccl.threshold_label(img, r, C, s, n, plan=p), ref, p)
                 for kind, p in plans.items()}
        what = "P3's 1920x1080 frame of random bytes, 3 rounds"
    elif mode == "--p1a":
        r, C, s = cs.PROBE_RADIUS, cs.PROBE_C, cs.PROBE_STRIDE
        img = cs._probe_frames(dev)["hd"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = ccl.block_plan(*img.shape[1:], img.shape[0], sms)
        calls = {"P1a": (lambda: (ccl.threshold_only(img, r, C, s),),
                         (ccl.threshold_only_reference(img, r, C, s),), plan)}
        what = f"{img.shape[0]} 1920x1080 float32 probe frames"
    else:
        frames = int(args[0]) if args else 1
        cfg = DetectorConfig()
        r, C, s, r1, r2 = (cfg.adaptive_radius, cfg.adaptive_C, cfg.mean_stride, cfg.ccl_rounds,
                           cfg.closed_ccl_rounds)
        img = cs._render_hd(frames, dev)
        ref = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
        plan = ccl.block_plan(1080, 1920, frames)
        calls = {"K3": (lambda: ccl.threshold_label_union(img, r, C, s, r1, r2), ref, plan),
                 "K5": (lambda: (ccl.label_components(ref[0], r1),),
                        (ccl.label_components_reference(ref[0], r1),), plan)}
        what = f"{frames} 1920x1080 frame(s)"
    out = {"card": smi.stdout.strip()}
    for name, (call, want, plan) in calls.items():
        for _ in range(2):  # the second launch is read: the first builds the plan
            got = call()
            torch.cuda.synchronize()
            lib.ccl_marks(marks.ctypes.data, count.ctypes.data)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SystemExit(f"{name}: the marked build differs from the plain version")
        out[name] = _segments(name, plan, marks, count, what)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
