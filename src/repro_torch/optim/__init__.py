from .adamw import OptConfig, adamw_init, adamw_update
from .schedule import cosine_schedule

__all__ = ["OptConfig", "adamw_init", "adamw_update", "cosine_schedule"]
