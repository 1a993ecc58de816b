"""The MC-CNN cost provider: the configuration's tower from the
flax-layout ``.npz`` its ``weights`` names, loaded by the program's own
loader, in its ``compute_dtype``."""


def build(cfg, dc, device, root):
    import torch
    from stereo_match_tpu_torch.costs import MCCNNCost
    from stereo_match_tpu_torch.models.mccnn import (from_flax_params,
                                                     load_params_npz)
    dtype = {"float32": torch.float32,
             "bfloat16": torch.bfloat16}[cfg["compute_dtype"]]
    model = from_flax_params(load_params_npz(root / cfg["weights"]),
                             (cfg["feature_maps"], cfg["conv_layers"]),
                             compute_dtype=dtype)
    return MCCNNCost(model.to(device), dc, scale=float(cfg["scale"]))
