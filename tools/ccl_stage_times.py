#!/usr/bin/env python3
"""Where the CCL cluster body's time goes, stage by stage, on one card.

Builds a copy of ``aruco_slam_tpu_torch/ops/kernels/csrc/ccl.cu`` with
``clock64()`` marks after each stage's barrier (thread 0 of every CTA of
the first frame's cluster), runs K3 (``threshold_label_union``) and K5
(``label_components``) through the port's wrappers on rendered 640x480
frames, and prints each stage's SM cycles: the median over launches of
CTA rank 0, and the largest over the 8 CTAs. The labels are checked
against the plain version, so the marks change no result. Needs one CUDA
card and nvcc.

    python3 tools/ccl_stage_times.py
"""

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MAX_MARKS = 128
# (anchor in the source, where the mark goes, stage that ends at the mark);
# "sync-before" puts a __syncthreads before the mark, where no barrier
# ends the stage
MARKS = [
    ("  b.band_px = (static_cast<size_t>(blockIdx.y) * a.h + b.y0) * a.w;\n", "after", "start"),
    ("  cluster_sync();  // every band's raw mask is in\n", "after", "threshold or mask load"),
    ("    cl_close(a, b);\n", "after", "close"),
    ("  cluster_sync();  // initial labels, edges and masks are in everywhere\n", "after",
     "label init"),
    ("    // a warp per 32-pixel word of a chunk row; a word with no foreground\n", "before",
     "halo rows"),
    ("      __syncthreads();\n      t = t0;\n", "after-line", "Jacobi chunk: compute"),
    ("        if ((mw >> lane) & 1u) *q = tmp[(y - c0) * w + x];\n      }\n      __syncthreads();\n",
     "after", "Jacobi chunk: write-back"),
    ("    // ---- column scans forward then backward, that is each vertical run's\n", "before",
     "row scans"),
    ("    cluster_sync();  // every band's run summaries are in\n", "sync-before",
     "column scans"),
    ("    cluster_sync();  // every band's run summaries are in\n", "after",
     "cluster barrier"),
    ("    if (it + 1 < rounds) cluster_sync();  // every band's edges are in\n", "before",
     "band join"),
    ("    if (it + 1 < rounds) cluster_sync();  // every band's edges are in\n", "after",
     "cluster barrier"),
    ("  for (int e = tid; e < R * w; e += kThreads) out[b.band_px + e] = lab[e];\n", "after",
     "label write-out"),
]
PRELUDE = """
__device__ unsigned long long g_marks[8 * %d];
__device__ int g_tags[8 * %d];
__device__ int g_count[8];  // marks so far, by CTA rank (thread 0 alone)
__device__ __forceinline__ void stage_mark(int tag) {
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    const int r = static_cast<int>(cg::this_cluster().block_rank());
    const int n = tag == 0 ? 0 : g_count[r];
    if (n < %d) {
      g_marks[r * %d + n] = clock64();
      g_tags[r * %d + n] = tag;
    }
    g_count[r] = n + 1;
  }
}
""" % ((MAX_MARKS,) * 5)
EPILOGUE = """
extern "C" int ccl_read_marks(unsigned long long* marks, int* tags, int* count) {
  cudaError_t err = cudaMemcpyFromSymbol(marks, g_marks, sizeof(g_marks));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(tags, g_tags, sizeof(g_tags));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(count, g_count, sizeof(g_count));
  return static_cast<int>(err);
}
"""


def instrumented_source() -> str:
    src = (ROOT / "aruco_slam_tpu_torch/ops/kernels/csrc/ccl.cu").read_text()
    for tag, (anchor, where, _) in enumerate(MARKS):
        if src.count(anchor) != 1:
            raise SystemExit(f"anchor not found once in ccl.cu: {anchor!r}")
        indent = anchor[: len(anchor) - len(anchor.lstrip())]
        mark = f"{indent}stage_mark({tag});\n"
        if where == "after":
            src = src.replace(anchor, anchor + mark)
        elif where == "after-line":  # after the anchor's first line
            first, rest = anchor.split("\n", 1)
            src = src.replace(anchor, first + "\n" + mark + rest)
        elif where == "before":
            src = src.replace(anchor, mark + anchor)
        elif where == "sync-before":
            src = src.replace(anchor, f"{indent}__syncthreads();\n" + mark + anchor)
    head = "namespace cg = cooperative_groups;\n"
    src = src.replace(head, head + PRELUDE, 1)
    return src + EPILOGUE


def main() -> int:
    import numpy as np
    import torch

    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.ops.detector import DetectorConfig
    from aruco_slam_tpu_torch.ops.kernels import _build, ccl
    from aruco_slam_tpu_torch.sim import renderer, synthetic

    if not torch.cuda.is_available():
        print("ccl_stage_times: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "stage_times"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, so = out_dir / "ccl_marked.cu", out_dir / "ccl_marked.so"
    src.write_text(instrumented_source())
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(proc.stderr[-4000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(so))
    lib.ccl_read_marks.argtypes = [ctypes.c_void_p] * 3
    lib.ccl_read_marks.restype = ctypes.c_int
    _build._loaded["ccl"] = lib  # the wrappers below launch the marked build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(4)
    poses = np.stack([rng.uniform(0.8, 4.3, 8), rng.uniform(-3.9, -0.8, 8),
                      rng.uniform(-np.pi, np.pi, 8)], axis=1)
    frames = renderer.render_poses(poses, synthetic.make_arena(n_markers=20),
                                   CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0),
                                   device=dev)
    det = DetectorConfig()
    r, C, s, r1, r2 = (det.adaptive_radius, det.adaptive_C, det.mean_stride, det.ccl_rounds,
                       det.closed_ccl_rounds)
    names = [m[2] for m in MARKS]
    marks = np.zeros(8 * MAX_MARKS, np.uint64)
    tags = np.zeros(8 * MAX_MARKS, np.int32)
    count = np.zeros(8, np.int32)
    runs = {
        "K3 threshold_label_union": lambda img: ccl.threshold_label_union(img, r, C, s, r1, r2),
        "K5 label_components": lambda img: ccl.label_components(
            ccl.threshold_label_union_reference(img, r, C, s, r1, r2)[0], r1),
    }
    for what, run in runs.items():
        per_stage = {}  # (position, stage) -> [rank 0 cycles], [max over ranks]
        for f in range(frames.shape[0]):
            img = frames[f: f + 1].contiguous()
            got = run(img)
            torch.cuda.synchronize()
            err = lib.ccl_read_marks(marks.ctypes.data, tags.ctypes.data, count.ctypes.data)
            if err:
                raise RuntimeError(f"reading the marks failed ({err})")
            if what.startswith("K3"):
                want = ccl.threshold_label_union_reference(img, r, C, s, r1, r2)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("the marked build differs from the plain version")
            m = marks.reshape(8, MAX_MARKS).astype(np.int64)
            t = tags.reshape(8, MAX_MARKS)
            if len(set(count.tolist())) != 1 or count[0] > MAX_MARKS:
                raise RuntimeError(f"the CTAs recorded {count.tolist()} marks")
            for k in range(1, int(count[0])):
                key = (k, names[t[0, k]])
                rank0 = int(m[0, k] - m[0, k - 1])
                worst = int(max(m[q, k] - m[q, k - 1] for q in range(8)))
                per_stage.setdefault(key, ([], []))
                per_stage[key][0].append(rank0)
                per_stage[key][1].append(worst)
        print(f"\n{what}, one 640x480 frame, {frames.shape[0]} launches: SM cycles per stage "
              f"(median; rank 0, and the largest over the 8 CTAs)")
        total = 0
        for (k, stage), (c0, cw) in sorted(per_stage.items()):
            total += statistics.median(c0)
            print(f"  {k:3d} {stage:32s} {statistics.median(c0):10.0f} {statistics.median(cw):10.0f}")
        print(f"  total (rank 0) {total:.0f} cycles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
