"""SGM at the layer's edges, a frame: the (D, H, W) cost read once and the
total written once (their dtype's bytes); per cell and path nine
operations (the path minimum, two adds and three minima of the
recurrence, the add of the cost, the subtraction, the add into the
total)."""

BYTES = {"float32": 4, "int16": 2}


def count(cfg: dict) -> dict:
    cells = cfg["num_disparities"] * cfg["height"] * cfg["width"]
    size = BYTES[cfg.get("dtype", "float32")]
    return {"bytes": 2.0 * size * cells,
            "flop": 9.0 * cfg["num_paths"] * cells,
            "tf32_flop": 0.0}
