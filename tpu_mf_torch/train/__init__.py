from tpu_mf_torch.train.loop import train_admf, train_dpmf, train_mf  # noqa: F401
