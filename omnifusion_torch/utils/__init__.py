from omnifusion_torch.utils import ply
from omnifusion_torch.utils.colorize import colorize

__all__ = ["colorize", "ply"]
