from osr_tpu_torch.utils.monitoring import QueryStats, SystemStats, StatsMonitor
from osr_tpu_torch.utils.hardware import detect_hardware_capabilities, validate_backend
from osr_tpu_torch.utils.timing import TimingContext, MemoryMonitor, percentiles

__all__ = [
    "QueryStats",
    "SystemStats",
    "StatsMonitor",
    "detect_hardware_capabilities",
    "validate_backend",
    "TimingContext",
    "MemoryMonitor",
    "percentiles",
]
