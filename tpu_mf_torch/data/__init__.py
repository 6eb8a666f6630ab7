from tpu_mf_torch.data.coo import RatingsCOO, synthetic_ratings  # noqa: F401
