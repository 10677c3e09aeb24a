"""Runtime utilities: profiling, performance stats, config flags, features,
checkpoints and AOT artifacts (``utils.aot``, imported on its own as in the
JAX package)."""

from .profiling import PerformanceMonitor, benchmark_fn, profile_trace
from .config import configure_cpu_precision, env_flag
from .checkpoint import CheckpointManager, load_checkpoint, save_checkpoint
from .features import (
    check_dependencies,
    get_available_features,
    get_installation_command,
    missing_dependencies,
    require_feature,
    test_installation,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
    "PerformanceMonitor",
    "benchmark_fn",
    "profile_trace",
    "configure_cpu_precision",
    "env_flag",
    "check_dependencies",
    "get_available_features",
    "get_installation_command",
    "missing_dependencies",
    "require_feature",
    "test_installation",
]
