"""Identity module (the reference's ``IdentityLayer``, declared in eleven
files — vit.py:20 etc.; used as a stage/branch placeholder)."""

from vitax._vendor.flax import linen as nn


class Identity(nn.Module):
    @nn.compact
    def __call__(self, x, *args, **kwargs):
        return x
