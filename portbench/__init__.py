"""The benchmark of the PyTorch and CUDA port ``aruco_slam_tpu_torch``:
``python3 -m portbench --workload NAME --seed N --seconds S --trace 0|1``
(see ``run.py``). It imports neither JAX nor the JAX package."""
