"""Training loops (``loop``) and their metrics and spans (``metrics``).
The loops load on first use, so that the kernel modules can import
``metrics`` without importing the loops that import them."""

_LOOPS = ("train_admf", "train_dpmf", "train_mf")


def __getattr__(name):
    if name in _LOOPS:
        from tpu_mf_torch.train import loop

        return getattr(loop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
