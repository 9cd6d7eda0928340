"""Model zoo of the port: the dense GQA transformer family."""
from .model import Model, decode_step, forward, init_cache, init_params
