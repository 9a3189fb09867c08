"""Models layer (port of rec_tpu/models, lossless flagship)."""

from .resnet_vae import BidirectionalResNetVAE, ResNetVAEConfig

__all__ = ["BidirectionalResNetVAE", "ResNetVAEConfig"]
