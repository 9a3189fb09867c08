"""Hand-written GPU kernels of the port and their plain PyTorch versions."""

from .beam_score import score_candidates

__all__ = ["score_candidates"]
