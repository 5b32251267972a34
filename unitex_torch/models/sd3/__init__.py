from .config import SD3Config
from .model import init_sd3_params, sd3_forward
