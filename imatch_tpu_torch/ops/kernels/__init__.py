"""Hand-written CUDA kernels (csrc/*.cu): build, bind and plain versions."""
