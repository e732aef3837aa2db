from repro_torch.configs.base import TahomaCNNConfig  # noqa: F401
