"""Hand-written CUDA kernels of the engine (counterpart of ``ops/pallas/``).

``engine_kernels`` (the engine's kernels) and ``int_matmul`` (the generic
int path's fused linear) hold each kernel's plain PyTorch version beside
its wrapper; ``build`` compiles ``csrc/*.cu`` with ``nvcc`` at first use. No
module here imports a compiler or touches the card when it is imported.
"""
