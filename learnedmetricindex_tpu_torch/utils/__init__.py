from learnedmetricindex_tpu_torch.utils.logging import Logger, log_runtime

__all__ = ["Logger", "log_runtime"]
