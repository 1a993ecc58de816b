"""The benchmark of ``stereo_match_tpu_torch`` (see README.md)."""
