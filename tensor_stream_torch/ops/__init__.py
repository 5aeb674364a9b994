"""The port's device ops. The quality metrics are exported here; the
kernels' wrappers (``nv12_rgb``, ``resize``, ``flash_attention``) and the
VPP are imported by module."""
from .metrics import psnr, ssim

__all__ = ["psnr", "ssim"]
