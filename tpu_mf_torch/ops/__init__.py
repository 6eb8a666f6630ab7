"""Update kernels: the batched SGD path and the fused dense-cell epoch."""
