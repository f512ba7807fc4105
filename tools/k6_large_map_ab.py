#!/usr/bin/env python3
"""K6's large-map design on one card: (a) K2's device program at one lane
(the cluster body on a cluster of 16 CTAs, the square's stripes in device
memory when they do not fit its shared memory) against (b) K6's grid
variant on the frame's active square, on the same states and frames; the
cluster variant beside (b) at 64 and 128 slots. (b) runs at the source's
narrowest stripe (``kGridMinCols`` = 4 in ``csrc/ekf_frame_update.cu``)
and at the other widths of MIN_COLS, each from a copy of the source with
that line changed, built into the package's build directory.

    python3 tools/k6_large_map_ab.py

States (chip_smoke.py's ``_k6_case``; a frame of 12 known markers, one at
its slot's last record, and 10 encoder ticks): 100, 300 and 512 landmarks
in 512 slots (N = 1,539: active squares of 303, 903 and 1,539 rows), 100
in 128 slots and 40 in 64. Per design it prints the kernel alone (device
ms a call, torch.profiler over 20 calls of the same inputs) in place (the
replay's form: mu and sigma updated where they are) and out of place, and
the largest sigma difference to the plain frame step. Needs one CUDA card.
"""

import ctypes
import importlib.util
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from aruco_slam_tpu_torch.models import ekf  # noqa: E402
from aruco_slam_tpu_torch.ops.kernels import _build  # noqa: E402
from aruco_slam_tpu_torch.ops.kernels import ekf_update as k6  # noqa: E402
from aruco_slam_tpu_torch.ops.kernels import ekf_update_batched as kb  # noqa: E402
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig  # noqa: E402

STATES = ((512, 100), (512, 300), (512, 512), (128, 100), (64, 40))
MIN_COLS_LINE = "constexpr int kGridMinCols = 4;"
MIN_COLS = (3, 8, 16)  # the grid's other narrowest stripes, beside the source's 4


def _build_min_cols(cols):
    """Path of K6's library built from a copy of its source whose grid
    stripes are at least ``cols`` columns."""
    src = (_build.CSRC / "ekf_frame_update.cu").read_text()
    if MIN_COLS_LINE not in src:
        raise RuntimeError(f"{MIN_COLS_LINE!r} is not in ekf_frame_update.cu")
    copy = _build.BUILD_DIR / f"ekf_frame_update_min_cols_{cols}.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(src.replace(MIN_COLS_LINE, f"constexpr int kGridMinCols = {cols};")
                    .replace('#include "', f'#include "{_build.CSRC}/'))
    out = copy.with_suffix(".so")
    _build._compile(copy, out)
    return out


def _use_library(lib):
    """K6's wrapper launches from ``lib`` from now on (its plans made anew)."""
    _build._loaded["ekf_frame_update"] = lib
    k6._plans.clear()


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_large_map_ab: needs a CUDA card", file=sys.stderr)
        return 2
    cs = _smoke()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    print(cs._card())
    source_lib = _build.load("ekf_frame_update")
    with ThreadPoolExecutor(len(MIN_COLS)) as pool:
        widths = dict(zip(MIN_COLS, (ctypes.CDLL(str(p))
                                     for p in pool.map(_build_min_cols, MIN_COLS))))
    widths[4] = source_lib
    for L, n_lm in STATES:
        cfg = SlamConfig(ekf=EkfConfig(max_landmarks=L, max_observations_per_frame=cs.M))
        rng = np.random.default_rng(n_lm)
        state = cs._k6_case(dev, cfg, n_lm, rng)
        frame = cs._k6_frame(state, rng, n_known=12, n_new=0)
        ticks = cs._k6_ticks(dev, rng, 1)
        ref = k6.frame_step_reference(state, frame, ticks, cfg)

        def in_place():
            """(the state, an ``out`` sharing its mu and sigma), on copies."""
            mu, sigma = state.mu.clone(), state.sigma.clone()
            return state._replace(mu=mu, sigma=sigma), ekf.init_state(cfg, 1, dev)._replace(
                mu=mu, sigma=sigma)

        def timed(launch, part):
            out = launch()
            torch.cuda.synchronize()
            return cs._kernel_ms(launch, part)[0], float((out.sigma - ref.sigma).abs().max())

        res = {}
        designs = [k6.variant(3 + 3 * L)] + ([("grid", 0)] if L <= k6.MAX_CLUSTER_LANDMARKS
                                             else [])
        for choice in designs:
            for cols, lib in sorted(widths.items()) if choice[0] == "grid" else [(4, source_lib)]:
                _use_library(lib)
                tag = f"b_grid_{cols}" if choice[0] == "grid" else "cluster"
                res[f"{tag}_out"], err = timed(
                    lambda: k6._launch(state, frame, cfg, choice, ticks), "ekf_frame_update")
                mine, spare = in_place()
                res[f"{tag}_in"], _ = timed(
                    lambda: k6._launch(mine, frame, cfg, choice, ticks, spare), "ekf_frame_update")
                res[f"{tag}_err"] = err
        _use_library(source_lib)
        if L > k6.MAX_CLUSTER_LANDMARKS:
            choice = kb.variant(3 + 3 * L, 1)
            res["a_out"], res["a_err"] = timed(
                lambda: kb.frame_step_batched(state, frame, ticks, cfg), "ekf_frame_batched")
            mine, _ = in_place()
            spare = kb._outputs(mine)._replace(mu=mine.mu, sigma=mine.sigma)
            res["a_in"], _ = timed(lambda: kb._launch(mine, frame, ticks, cfg, spare, None, choice),
                                   "ekf_frame_batched")
            res["a_choice"] = f"{choice[0]} G={choice[1]}"
        na = 3 + 3 * n_lm
        print(f"max_landmarks={L} landmarks={n_lm} (na={na}): " + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in res.items()),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
