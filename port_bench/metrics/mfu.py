"""The whole frame's share of the TF32 tensor-core peak: the network's
float32 products a frame (tower and band, ``work/mccnn_cost.py``) at the
traced window's frame rate. Read only where the card was traced and the
cost layer does such products."""


def read(r):
    work = r.work.get("cost")
    if not r.devices or not work or not work.get("tf32_flop") \
            or not r.frames:
        return None
    rate = r.frames / r.window_s
    return 100.0 * work["tf32_flop"] * rate / r.peaks["tf32_flop_per_s"]
