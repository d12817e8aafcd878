from learnedmetricindex_tpu_torch.utils.logging import Logger, log_runtime
from learnedmetricindex_tpu_torch.utils.timing import Timer

__all__ = ["Logger", "log_runtime", "Timer"]
