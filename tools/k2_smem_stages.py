#!/usr/bin/env python3
"""Where K2-smem's time goes, stage by stage, lane by lane, on one card.

Builds a copy of ``aruco_slam_tpu_torch/ops/kernels/csrc/ekf_frame_batched.cu``
with ``%globaltimer`` marks (the card's nanosecond clock, one for every SM)
written by thread 0 of every lane's CTA at the kernel's start, the
compose's end, the prologue's end (slot lookup and sort), the moment sigma is in
shared memory (where the source waits for an asynchronous copy), the
predict's end, each known observation's two barriers (phase A: B, the Gram
partials and the first barrier; then S, the gate, the rank-3 update and the
second barrier), each insert's barrier and the write-back's end; where the
source loads sigma with its warps, the first loading thread marks the end
of its loop apart. It runs the smem variant through the port's wrapper at
the Monte-Carlo cell's shape (``arena20_corners_b4096``: 4,096 lanes, N 99,
16 slots, 10 encoder ticks a frame; the frames from ``portbench``'s
generator and ``--seed``): a replay up to ``--frame`` (default 300) makes
the state, K1 makes that frame's observations, and the marked launch of
that frame is read (the second of two, the first builds the plan). For each
stage it prints the median and the largest time over lanes (a stage met
several times in a lane is summed), the time a lane spends from start to
end, the launch's span and the lanes it held in flight, with the plan's
threads a lane, resident lanes per SM and waves.

Also marked: the observations' loop's end (its last barrier). Where the
other warps run the lookup and sort while warp 0 composes, the
``lookup+sort`` stage is warp 0's wait for them at the prologue's barrier.

``TREE`` (default: this checkout) is the root of the checkout whose port,
kernel source and ``chip_smoke.py`` run, so that two trees compare on one
card; the marks whose anchor lines another tree's source lacks are left out
and named (this tree's source must hold every anchor of its own). The
output is checked against the plain version
(``ekf_update_batched.frame_step_reference``), so the marks change no
result. The marks anchor on lines of ``csrc/ekf_frame_batched.cu``: edit
them together. The last line is a JSON object of every stage. Needs one
CUDA card and nvcc.

    python3 tools/k2_smem_stages.py [TREE] [--frame F] [--seed S]
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORKLOAD = "arena20_corners_b4096"
MAX_LANES, MAX_MARKS = 4096, 48
PRELUDE = """
__device__ unsigned long long g_marks[%d * %d];
__device__ int g_count[%d];
__device__ unsigned long long g_load[%d];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
// a mark: the global timer in the high bits, the tag in the low 4
__device__ __forceinline__ void mark(int tag) {
  if (threadIdx.x == 0 && blockIdx.x < %d && g_count[blockIdx.x] < %d)
    g_marks[blockIdx.x * %d + g_count[blockIdx.x]++] = (gtime() << 4) | tag;
}
// the end of the load loop of the thread `by`
__device__ __forceinline__ void mark_load(int by) {
  if (threadIdx.x == by && blockIdx.x < %d) g_load[blockIdx.x] = gtime();
}
""" % (MAX_LANES, MAX_MARKS, MAX_LANES, MAX_LANES, MAX_LANES, MAX_MARKS, MAX_MARKS, MAX_LANES)
READER = """
extern "C" int k2_marks(unsigned long long* out, int* count, unsigned long long* load) {
  cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks));
  cudaMemcpyFromSymbol(count, g_count, sizeof(g_count));
  cudaMemcpyFromSymbol(load, g_load, sizeof(g_load));
  static int zero[%d] = {0};
  return static_cast<int>(cudaMemcpyToSymbol(g_count, zero, sizeof(zero)));
}
""" % MAX_LANES
TAGS = {0: "start", 8: "compose", 1: "lookup+sort", 2: "sigma wait", 3: "predict",
        4: "phase A", 5: "gate+update", 6: "insert", 9: "chain's end", 7: "write-back"}
# (anchors in ekf_frame_batched.cu, the first found once is used; the mark
# after it). A tag of None is the load loop's end by thread 32.
MARKS = [
    (["  int n_lm = io.n_lm[b];\n"], 0),
    (["    compose_staged(io, od, b, N, pq, Bb, 6 * N);\n",
      "  if (warp == 0) {\n    compose_batch_lane(io, od, b, N, pq);\n"], 8),
    (["                    kThreads - 32);\n  }\n  __syncthreads();\n",
      "  lookup_and_sort(io.slot_ids + (long long)b * L, ids, valid, L, M, s_slot, s_order);\n"],
     1),
    (["  wait_loaded(bar);\n"], 2),
    (["        if (e < NN) s[e] = v[u];\n      }\n    }\n"], None),
    (["    if (tid < 3) mu[tid] = mu0[tid] = pq[tid];\n    __syncthreads();\n  }\n"], 3),
    (["        for (int q = 0; q < 6; ++q) G[warp * 6 + q] = g[q];\n      }\n"
      "      __syncthreads();\n"], 4),
    (["      diverged += div_hit ? 1 : 0;\n"], 5),
    (["      n_lm += 1;\n      __syncthreads();\n"], 6),
    (["  }\n  __syncthreads();\n\n  // ---- write back"], 9),
    (["  for (int j = tid; j < N; j += kThreads) io.mu_out[(long long)b * N + j] = mu[j];\n"], 7),
]


def marked_source(csrc: Path, strict: bool = True) -> tuple[str, list]:
    """ekf_frame_batched.cu with the marks in place, and the tags left out.
    ``strict``: every anchor but the two of the sigma load (one source has
    one of them) must be found once; else a mark whose anchor is missing
    is left out."""
    src = (csrc / "ekf_frame_batched.cu").read_text()
    include = '#include "ekf_frame_common.cuh"\n'
    if src.count(include) != 1:
        raise SystemExit(f"anchor not found once in ekf_frame_batched.cu: {include!r}")
    src = src.replace(include, include + PRELUDE)
    missing = []
    for anchors, tag in MARKS:
        found = [a for a in anchors if src.count(a) == 1]
        name = TAGS.get(tag, "load (thread 32)")
        if not found:
            if strict and tag not in (2, None):
                raise SystemExit(f"anchor not found once in ekf_frame_batched.cu: {anchors[0]!r}")
            missing.append(name)
            continue
        call = "mark_load(32)" if tag is None else f"mark({tag})"
        if tag == 9:  # after the anchor's second line, before the write-back's comment
            first, rest = found[0].split("\n\n", 1)
            src = src.replace(found[0], first + f"\n  {call};\n\n" + rest)
        else:
            src = src.replace(found[0], found[0] + f"  {call};\n")
    if "sigma wait" in missing and "load (thread 32)" in missing:
        raise SystemExit("neither anchor of the sigma load found in ekf_frame_batched.cu")
    return src + READER, missing


def stages(marks, count, load, lanes: int) -> dict:
    """Per-stage lane sums (median and largest over lanes), each stage's
    occurrences, the lane's whole time, the load loop's end, the launch's
    span and the lanes it held in flight on average."""
    import numpy as np

    n = count[:lanes]
    raw = marks.reshape(MAX_LANES, MAX_MARKS)[:lanes]
    t = (raw >> np.uint64(4)).astype(np.int64)  # the timer's low 60 bits
    tags = (raw & np.uint64(15)).astype(int)
    if n.min() < 2 or n.max() >= MAX_MARKS:
        raise SystemExit(f"marks a lane {n.min()}-{n.max()}: none read, or the buffer is full")
    start = t[:, 0]
    end = t[np.arange(lanes), n - 1]
    out = {}
    for tag, name in TAGS.items():
        if tag == 0:
            continue
        sums, occ = np.zeros(lanes), np.zeros(lanes, int)
        for b in range(lanes):
            d = np.diff(t[b, :n[b]]) / 1e3
            sel = tags[b, 1:n[b]] == tag
            sums[b], occ[b] = d[sel].sum(), sel.sum()
        if occ.sum():
            out[name] = {"median_us": float(np.median(sums)), "largest_us": float(sums.max()),
                         "count_median": float(np.median(occ)),
                         "each_median_us": float(np.median(sums[occ > 0] / occ[occ > 0]))}
    lane_us = (end - start) / 1e3
    span_us = (end.max() - start.min()) / 1e3
    res = {"stages": out,
           "lane_us": {"median": float(np.median(lane_us)), "largest": float(lane_us.max())},
           "span_us": float(span_us), "in_flight": float(lane_us.sum() / span_us)}
    if load[:lanes].any():
        lu = ((load[:lanes] & np.uint64(2**60 - 1)).astype(np.int64) - start) / 1e3
        res["load_loop_us"] = {"median": float(np.median(lu)), "largest": float(lu.max())}
    return res


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree", nargs="?", default=str(ROOT))
    ap.add_argument("--frame", type=int, default=300)
    ap.add_argument("--seed", type=int, default=1_234_567_891)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    if tree != ROOT:
        sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from aruco_slam_tpu_torch.ops.kernels import _build, ekf_update_batched as kb
    from portbench import cell as cellmod
    from portbench.spec import Spec

    if not torch.cuda.is_available():
        print("k2_smem_stages: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"kernel source: {_build.CSRC}")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "ekf_frame_batched.cu"
        text, missing = marked_source(_build.CSRC, strict=tree == ROOT)
        src.write_text(text)
        for h in _build.CSRC.glob("*.cuh"):
            shutil.copy(h, tmp)
        report = _build._compile(src, Path(tmp) / "ekf_frame_batched.so")
        lib = ctypes.CDLL(str(Path(tmp) / "ekf_frame_batched.so"))
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    if missing:
        print(f"(no marks {missing} in {tree}: their anchors are not in that source)")
    lib.k2_marks.argtypes = [ctypes.c_void_p] * 3
    _build._loaded["ekf_frame_batched"] = lib  # the wrapper launches the marked build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    spec = Spec()
    w = spec.workload(WORKLOAD)
    cell = cellmod.Cell(spec.config(w["config"]), spec.traffic(w["traffic"]), args.seed, dev)
    prog = cellmod.Program(cell)
    data, cfg, cam = prog.data, prog.slam, prog.camera
    f = args.frame
    warm = prog.runner.replay_batch(data._replace(**{
        k: v[:, :f] for k, v in data._asdict().items() if v is not None}), cfg, cam, "corners")
    state = warm.final_state
    frame, controls = cs._k2_frame(f, data, cfg, cam)
    B, N = state.mu.shape
    L, M, T = cfg.ekf.max_landmarks, frame.ids.shape[1], controls.dt.shape[1]
    marks = np.zeros(MAX_LANES * MAX_MARKS, np.uint64)
    count = np.zeros(MAX_LANES, np.int32)
    load = np.zeros(MAX_LANES, np.uint64)
    for _ in range(2):  # the second launch is read
        lib.k2_marks(marks.ctypes.data, count.ctypes.data, load.ctypes.data)
        out = kb.frame_step_batched(state, frame, controls, cfg)
        torch.cuda.synchronize()
    lib.k2_marks(marks.ctypes.data, count.ctypes.data, load.ctypes.data)
    ref = kb.frame_step_reference(state, frame, controls, cfg)
    torch.cuda.synchronize()
    err = cs._k2_check(out, ref, f"(marked smem, B={B}) frame {f}")

    d = torch.cuda.current_device()
    choice = kb._choices[(d, N, M, B)]
    if choice[0] != "smem":
        raise SystemExit(f"the wrapper chose {choice[0]}, not smem")
    threads = choice[3] if len(choice) > 3 else 256  # a tree with one smem plan: 256
    try:
        resident = kb._plan(lib, d, "smem", N, L, M, 1, threads)[1]
    except TypeError:  # a tree whose plans take no threads
        resident = kb._plan(lib, d, "smem", N, L, M, 1)[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-B // (resident * sms))
    known = int((frame.valid & (kb.frame_step_inputs(state, frame, controls, cfg)[7] >= 0)).sum())
    res = stages(marks, count, load, B)
    print(f"K2-smem at B={B} N={N} M={M} T={T}, frame {f} of seed {args.seed} "
          f"({known} known observations, landmarks {int(state.n_landmarks.min())}-"
          f"{int(state.n_landmarks.max())}); {threads} threads a lane, {resident} resident "
          f"lanes an SM, {sms} SMs, {waves} waves; max |err| against the plain version "
          f"{err:.3e}")
    print(f"  lane start to end: median {res['lane_us']['median']:.2f} us, largest "
          f"{res['lane_us']['largest']:.2f} us; launch span {res['span_us']:.1f} us, "
          f"{res['in_flight']:.1f} lanes in flight on average "
          f"({res['in_flight'] / sms:.2f} an SM)")
    if "load_loop_us" in res:
        print(f"  load loop's end (thread 32) after the start: median "
              f"{res['load_loop_us']['median']:.2f} us, largest "
              f"{res['load_loop_us']['largest']:.2f} us")
    for name, s in res["stages"].items():
        print(f"  {name:12s} median {s['median_us']:7.2f} us, largest {s['largest_us']:7.2f} us "
              f"a lane; {s['count_median']:.0f} a lane (median), {s['each_median_us']:.2f} us "
              f"each")
    print(json.dumps({"card": smi.stdout.strip(), "tree": str(tree), "B": B, "N": N, "M": M,
                      "T": T, "frame": f, "seed": args.seed, "threads": threads,
                      "resident": resident, "sms": sms, "waves": waves, "known": known,
                      "max_err": err, "missing": missing, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
