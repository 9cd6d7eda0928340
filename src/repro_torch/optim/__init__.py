"""Optimisers of the port (no ``torch.optim``): AdamW and the cosine schedule."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
