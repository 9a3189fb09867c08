"""Relative entropy coding core (port of rec_tpu/coding)."""

from .coder import BeamSearchCoder, CodedLatent, Coder, GaussianCoder
from .gauss import GaussianParams, kl_divergence
from .rejection import RejectionSampler, RejectionSamplerConfig
from .rejection_coder import RejectionCoder
from .utils import CodingError

__all__ = ["BeamSearchCoder", "CodedLatent", "Coder", "GaussianCoder",
           "GaussianParams", "RejectionCoder", "RejectionSampler",
           "RejectionSamplerConfig", "kl_divergence", "CodingError"]
