from tpu_mf_torch.train.loop import train_dpmf, train_mf  # noqa: F401
