from openess_tpu_torch.config.settings import Settings, load_settings

__all__ = ["Settings", "load_settings"]
