"""nisaba-parity namespace: ``ns.experimental.physics.tens_style.*``."""

from tpinn_torch.experimental import physics

__all__ = ["physics"]
