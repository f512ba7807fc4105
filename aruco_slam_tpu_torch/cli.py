"""Command-line interface (L4) — counterpart of ``aruco_slam_tpu.cli``, the
reference's roslaunch entry point (launch/slam.launch) minus the message
bus. The flags and JSON lines are the JAX CLI's, plus ``--device``.

Subcommands:
- ``simulate`` — generate a synthetic sequence (arena + trajectory) to .npz
- ``replay``   — run EKF-SLAM over a sequence, report ATE/RPE/map metrics,
  optionally export the learned map (map.txt schema), a JSONL run log and
  a plot
- ``ba``       — build a factor graph from a sequence and optimize it

``--device`` (replay, ba) names the torch device; the default is the card.

Usage: python -m aruco_slam_tpu_torch.cli <subcommand> [options]
"""

from __future__ import annotations

import argparse
import json


def _add_common(p):
    p.add_argument("--config", help="YAML config (reference parameters.yaml schema)")
    p.add_argument("--max-landmarks", type=int, default=None,
                   help="override ekf.max_landmarks (default: config value or 64)")
    p.add_argument("--max-obs", type=int, default=None,
                   help="override ekf.max_observations_per_frame")
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the card, cuda)")


_CAMERA_HELP = (
    "camera intrinsics fx,fy,cx,cy[,k1,k2,p1,p2,k3] (OpenCV distortion "
    "order). Replay/ba default to the calibration STORED IN THE SEQUENCE "
    "(the reference reads K/D from the CameraInfo stream, "
    "src/aruco_slam_node.cpp:121-130); pass this only to override it."
)


def _parse_camera(spec: str):
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics

    vals = [float(v) for v in spec.split(",")]
    if len(vals) < 4 or len(vals) > 9:
        raise SystemExit(
            f"--camera wants fx,fy,cx,cy[,k1,k2,p1,p2,k3]; got {len(vals)} values"
        )
    dist = vals[4:] + [0.0] * (9 - len(vals))
    return CameraIntrinsics.create(*vals[:4], dist=dist)


def _camera_for(seq, args):
    """Camera priority: explicit --camera > the sequence's own calibration
    > the simulator default (for old sequences saved without one)."""
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics

    if getattr(args, "camera", None):
        return _parse_camera(args.camera)
    cam = seq.camera()
    if cam is not None:
        return cam
    return CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)


def _load_config(args):
    import dataclasses

    from aruco_slam_tpu_torch.utils.config import SlamConfig, load_config

    cfg = load_config(args.config) if args.config else SlamConfig()
    # CLI flags override the loaded config only when explicitly given
    overrides = {}
    if args.max_landmarks is not None:
        overrides["max_landmarks"] = args.max_landmarks
    if args.max_obs is not None:
        overrides["max_observations_per_frame"] = args.max_obs
    if overrides:
        cfg = dataclasses.replace(cfg, ekf=dataclasses.replace(cfg.ekf, **overrides))
    return cfg


def cmd_simulate(args):
    from aruco_slam_tpu_torch.io import map_io
    from aruco_slam_tpu_torch.ops.camera import CameraIntrinsics
    from aruco_slam_tpu_torch.sim import synthetic

    marker_map = map_io.load_map(args.map) if args.map else synthetic.make_arena(
        n_markers=args.markers
    )
    cam = (
        _parse_camera(args.camera)
        if args.camera
        else CameraIntrinsics.create(600.0, 600.0, 320.0, 240.0)
    )
    p = synthetic.SimParams(duration=args.duration, seed=args.seed)
    seq = synthetic.generate_sequence(
        p, marker_map=marker_map, level=args.level,
        camera=cam if args.level != "obs" else None,
    )
    seq.save(args.out, image_format=args.image_format)
    print(json.dumps({"frames": seq.num_frames, "out": args.out, "level": args.level}))


def cmd_replay(args):
    from aruco_slam_tpu_torch import runner
    from aruco_slam_tpu_torch.io import checkpoint
    from aruco_slam_tpu_torch.io.sequence import Sequence
    from aruco_slam_tpu_torch.models import ekf
    from aruco_slam_tpu_torch.utils import logging as slog

    cfg = _load_config(args)
    seq = Sequence.load(args.sequence)
    cam = _camera_for(seq, args)
    result = runner.replay_sequence(seq, cfg, cam, args.level, device=args.device)
    res = runner.evaluate_sequence(seq, cfg, camera=cam, level=args.level, result=result)
    if args.log:
        slog.write_replay_log(args.log, result)
    if args.plot:
        from aruco_slam_tpu_torch import viz

        viz.plot_run(result, seq, args.plot)
    if args.export_map:
        lms, ids, active = ekf.get_map(result.final_state, cfg)
        checkpoint.export_learned_map(
            args.export_map, lms[0], ids[0], active[0],
            marker_length=cfg.aruco.marker_length,
        )
    print(json.dumps(res))


def cmd_ba(args):
    from aruco_slam_tpu_torch import convert
    from aruco_slam_tpu_torch.io.sequence import Sequence
    from aruco_slam_tpu_torch.models import ba, graph_builder

    cfg = _load_config(args)
    seq = Sequence.load(args.sequence)
    if args.ekf_init:
        # filter -> smoother: EKF pass first, BA initialized from its output
        # (a long drifty dead-reckoned chain can trap Gauss-Newton).
        from aruco_slam_tpu_torch import pipeline

        out = pipeline.ekf_then_ba(
            seq, cfg, keyframe_stride=args.stride,
            ba_iters=args.iters, cg_iters=args.cg_iters, device=args.device,
        )
        problem, stats = out["problem"], out["stats"]
    else:
        problem, _ = graph_builder.build_from_sequence(seq, cfg, keyframe_stride=args.stride)
        _, _, stats = ba.solve(
            convert.ba_problem_from_numpy(problem, args.device), iters=args.iters,
            cg_iters=args.cg_iters, adaptive=True, deflate_gauge=True,
        )
    print(
        json.dumps(
            {
                "keyframes": int(problem.poses.shape[0]),
                "landmarks": int(problem.landmarks.shape[0]),
                "initial_cost": float(stats.initial_cost),
                "final_cost": float(stats.final_cost),
            }
        )
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="aruco_slam_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("simulate", help="generate a synthetic sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--duration", type=float, default=30.0)
    p.add_argument("--markers", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--level", choices=["obs", "corners", "images"], default="obs")
    p.add_argument("--map", help="ground-truth map.txt to use as the world")
    p.add_argument("--camera", help=_CAMERA_HELP)
    p.add_argument("--image-format", choices=["npz", "asq"], default="npz",
                   help="asq (a native mmap/CRC container) is not ported yet and raises")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("replay", help="run EKF-SLAM over a sequence")
    p.add_argument("--sequence", required=True)
    p.add_argument("--level", choices=["obs", "corners", "images"], default="obs")
    p.add_argument("--camera", help=_CAMERA_HELP)
    p.add_argument("--log", help="write per-frame JSONL records here")
    p.add_argument("--export-map", help="write learned map (map.txt schema)")
    p.add_argument("--plot", help="write a trajectory/map plot (PNG)")
    _add_common(p)
    p.set_defaults(fn=cmd_replay)

    p = sub.add_parser("ba", help="factor-graph optimization over a sequence")
    p.add_argument("--sequence", required=True)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--cg-iters", type=int, default=200)
    p.add_argument("--ekf-init", action="store_true",
                   help="run the EKF first and initialize BA from its "
                        "trajectory/map (filter -> smoother pipeline)")
    _add_common(p)
    p.set_defaults(fn=cmd_ba)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
