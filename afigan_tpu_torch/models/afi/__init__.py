from .discriminator import PatchDiscriminator
from .generator import AFIGenerator, ResidualDenseBlock, ResidualInResidual

__all__ = ["AFIGenerator", "PatchDiscriminator", "ResidualDenseBlock", "ResidualInResidual"]
