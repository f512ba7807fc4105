"""End-to-end demo through the port: simulate a marker arena, run EKF-SLAM,
refine with BA, score it, and export the learned map and a trajectory plot
(the JAX package's ``examples/demo.py``).

    python -m aruco_slam_tpu_torch.demo [out_dir] [--device cpu] [--duration S]

The device defaults to the card.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from aruco_slam_tpu_torch import pipeline, runner, viz
from aruco_slam_tpu_torch.io import checkpoint
from aruco_slam_tpu_torch.models import ekf
from aruco_slam_tpu_torch.sim import synthetic
from aruco_slam_tpu_torch.utils.config import EkfConfig, SlamConfig


def main(out_dir: str | None = None, device=None, duration: float = 30.0) -> dict:
    """Run the demo into ``out_dir`` (default: ``aruco_slam_demo`` in the
    temporary directory) on ``device`` (None: the card). Returns the
    metrics, the BA costs and the paths written (``plot`` None where
    matplotlib is missing)."""
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "aruco_slam_demo")
    os.makedirs(out_dir, exist_ok=True)
    cfg = SlamConfig(ekf=EkfConfig(max_landmarks=32, max_observations_per_frame=16))

    print(f"simulating {duration:g} s in a 20-marker arena ...")
    seq = synthetic.generate_sequence(synthetic.SimParams(duration=duration, seed=1))

    print("running EKF-SLAM + BA (filter -> smoother) ...")
    out = pipeline.ekf_then_ba(seq, cfg, device=device)
    result = out["ekf_result"]
    metrics = runner.evaluate_sequence(seq, cfg, result=result)
    costs = (float(out["stats"].initial_cost), float(out["stats"].final_cost))
    print("  ", metrics)
    print("   BA cost:", costs[0], "->", costs[1])

    lms, ids, active = ekf.get_map(result.final_state, cfg)
    map_path = os.path.join(out_dir, "learned_map.txt")
    checkpoint.export_learned_map(map_path, lms[0], ids[0], active[0],
                                  marker_length=cfg.aruco.marker_length)
    print("learned map ->", map_path)

    plot_path = os.path.join(out_dir, "trajectory.png")
    if viz.plot_run(result, seq, plot_path):
        print("plot ->", plot_path)
    else:
        plot_path = None
    return {"metrics": metrics, "ba_cost": costs, "map": map_path, "plot": plot_path}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="python -m aruco_slam_tpu_torch.demo")
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: the card, cuda)")
    ap.add_argument("--duration", type=float, default=30.0, help="simulated seconds")
    args = ap.parse_args()
    main(args.out_dir, args.device, args.duration)
