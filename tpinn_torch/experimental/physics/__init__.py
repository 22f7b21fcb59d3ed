from tpinn_torch.experimental.physics import tens_style

__all__ = ["tens_style"]
