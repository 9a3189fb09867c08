"""Models layer (port of rec_tpu/models): the lossless flagship here, the
lossy VAEs in ``lossy``."""

from .resnet_vae import BidirectionalResNetVAE, ResNetVAEConfig

__all__ = ["BidirectionalResNetVAE", "ResNetVAEConfig"]
