from tpu_mf_torch.train.loop import train_mf  # noqa: F401
