"""tpu_mf_torch: the PyTorch / CUDA port of tpu_mf for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; each Pallas TPU kernel of ``tpu_mf`` becomes a
kernel written by hand for Hopper under ``csrc/``, with a plain PyTorch
version beside it that CPU tensors take. ``tpu_mf`` stays the reference the
port is tested against; the port imports nothing of it, and keeps its own
copies of the JAX-free modules it needs (``config``, ``data``, ``native``,
``tools``).
"""

__version__ = "0.1.0"

from tpu_mf_torch.config import TrainConfig  # noqa: F401
from tpu_mf_torch.train.loop import train_mf  # noqa: F401
