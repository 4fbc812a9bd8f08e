# Hand-written Hopper kernels (csrc/*.cu, built by _build.py), their
# plain PyTorch versions (ref.py) and the device dispatch (ops.py).
