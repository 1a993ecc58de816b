"""The matching configuration, shared with the JAX package.

``stereo_match_tpu.config`` imports only the standard library, so both
packages take the one ``DisparityConfig`` (its P1/P2 derivation and the
multiple-of-16 rounding of ``num_disparities``) and the one INI loader.
This is the only import the port takes from the JAX package.
"""

from stereo_match_tpu.config import DisparityConfig, load_settings

__all__ = ["DisparityConfig", "load_settings"]
