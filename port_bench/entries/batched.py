"""``StereoMatcher.batched`` on a call's frames."""


def build(cfg, devices, root):
    from port_bench import system
    from stereo_match_tpu_torch.pipeline.stereo import StereoMatcher
    dc = system.disparity_config(cfg)
    matcher = StereoMatcher(dc, system.cost_fn(cfg, dc, devices[0], root),
                            device=devices[0])
    return lambda ls, rs: matcher.batched(ls, rs)[0]
