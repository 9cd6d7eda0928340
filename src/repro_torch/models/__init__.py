"""Model zoo of the port: the dense, moe, hybrid and ssm families."""
from .model import Model, decode_step, forward, init_cache, init_params, loss_fn
