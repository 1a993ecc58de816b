"""Census cost at the layer's edges, a frame: two float32 images in, the
(D, H, W) float32 volume out; a compare per window pixel and view, and an
XOR and a popcount per volume cell."""


def count(cfg: dict) -> dict:
    H, W, D = cfg["height"], cfg["width"], cfg["num_disparities"]
    wh, ww = cfg["census_window"]
    return {"bytes": 4.0 * (2 * H * W + D * H * W),
            "flop": 2.0 * H * W * (wh * ww - 1) + 2.0 * D * H * W,
            "tf32_flop": 0.0}
