"""Exact solutions for the analytic cases."""

from tpinn_torch.oracles import analytic

__all__ = ["analytic"]
