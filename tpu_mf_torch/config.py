"""Training configuration (the port's copy of ``tpu_mf/config.py``).

Mirrors every CLI flag of the reference trainer (reference: src/main.cc:95-164;
defaults at src/main.cc:97-105) plus execution knobs that have no reference
counterpart (batch size, mesh shape, dtype, RNG seed). Fields, defaults and
schedules are ``tpu_mf``'s, so one configuration means the same run in both
packages (``tests/test_torch_copies.py`` holds them equal).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class TrainConfig:
    # --- data / io (reference flags: --train/--test/--valid/--result/--model) ---
    train: Optional[str] = None
    test: Optional[str] = None
    valid: Optional[str] = None
    result: Optional[str] = None  # checkpoint output prefix
    model: Optional[str] = None   # warm-start checkpoint to load

    # --- algorithm selection (reference: --alg {mf,dpmf,admf}) ---
    alg: str = "mf"

    # --- model shape (reference: --dim/--nu/--nv, defaults main.cc:97-105) ---
    dim: int = 128
    nu: int = 0
    nv: int = 0

    # --- optimization (reference: --iter/--eta/--lambda/--gam/--bias/--mineta) ---
    iters: int = 15
    eta: float = 2e-2
    lam: float = 5e-3
    gam: float = 1.0
    gb: float = 2.76          # global bias ("--bias")
    mineta: float = 1e-13

    # --- DP-SGLD (reference: --epsilon/--tau/--hypera/--hyperb/--temp/--noise_size) ---
    epsilon: float = 0.0
    tau: int = 0
    hypera: float = 1.0
    hyperb: float = 100.0
    temp: float = 1.0
    noise_size: int = 2_000_000_000  # accepted for CLI parity; unused (on-chip PRNG)

    # --- adaptive regularization (reference: --eta_reg/--loss/--measure) ---
    eta_reg: float = 2e-3
    loss: int = 0       # 0 = least squares, 1 = logistic
    measure: int = 0    # 0 = RMSE

    # --- legacy concurrency flags, accepted for parity (reference: --fly/--stride).
    # fly was TBB pipeline tokens, stride a software-prefetch distance; neither has
    # meaning here. fly seeds the host prefetch depth of the input pipeline.
    fly: int = 8
    stride: int = 2

    # --- execution knobs (no reference counterpart) ---
    # Ratings per synchronous SGD step. Stability rule of thumb on skewed
    # data: a row appearing k times in one gather window accumulates k stale
    # gradients, so keep (batch_size * max_item_share) * eta well below 2.
    # The fused kernels apply 8 sequential sub-batches per step, which
    # relaxes this by 8x relative to the batched path.
    batch_size: int = 4096
    seed: int = 0
    dtype: str = "float32"     # storage dtype of factor tables
    mesh: int = 1              # number of devices for diagonal-block DSGD
    use_pallas: bool = True    # use the fused kernels when eligible
    use_dense: bool = True     # dense-cell MF kernel when cells fit HBM
    eval_batch: int = 1 << 20  # chunk size for RMSE evaluation

    # --- observability / failure recovery (SURVEY §5; no reference counterpart) ---
    metrics: Optional[str] = None   # JSONL metrics path (train/metrics.py)
    trace: Optional[str] = None     # torch.profiler trace dir
    resume: bool = False            # auto checkpoint/resume per round (io/resume.py)
    resume_every: int = 1           # save-round cadence when resume is on

    def eta_at(self, round_: int) -> float:
        """LR schedule eta(round) = eta0 / round**gam (reference: model.cc:36-38)."""
        return float(self.eta / (round_ ** self.gam))

    def eta_at_cutoff(self, round_: int) -> float:
        """SGLD schedule with mineta clamp (reference: model.cc:350-352)."""
        return float(max(self.mineta, self.eta / (round_ ** self.gam)))

    def eta_reg_at(self, round_: int) -> float:
        """Adaptive-reg LR schedule (reference: model.cc:386-388)."""
        return float(self.eta_reg / (round_ ** self.gam))
