"""MC-CNN cost at the layer's edges, a frame: the tower's products for
both views (2 * 9 * C_in * F a pixel and layer) and the band's (2 * F a
cell with x >= d), float32 products counted once; two float32 images and
the weights in, the (D, H, W) float32 volume out."""


def band_cells(cfg: dict) -> int:
    """Volume cells with a right sample: x >= d."""
    H, W = cfg["height"], cfg["width"]
    lo = cfg["min_disparity"]
    return H * sum(max(W - d, 0)
                   for d in range(lo, lo + cfg["num_disparities"]))


def tower_flop(cfg: dict) -> float:
    H, W, F = cfg["height"], cfg["width"], cfg["feature_maps"]
    per_pixel = sum(2 * 9 * (1 if i == 0 else F) * F
                    for i in range(cfg["conv_layers"]))
    return 2.0 * H * W * per_pixel


def count(cfg: dict) -> dict:
    H, W, D, F = (cfg["height"], cfg["width"], cfg["num_disparities"],
                  cfg["feature_maps"])
    weights = sum(9 * (1 if i == 0 else F) * F + F
                  for i in range(cfg["conv_layers"]))
    return {"bytes": 4.0 * (2 * H * W + weights + D * H * W),
            "tf32_flop": tower_flop(cfg) + 2.0 * F * band_cells(cfg),
            "flop": 0.0}
