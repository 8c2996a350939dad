from .harness import build_rollout, device_info, measure_env_steps_per_sec

__all__ = ["build_rollout", "device_info", "measure_env_steps_per_sec"]
