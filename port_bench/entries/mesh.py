"""``parallel/batch.py::batched_matcher`` over a ``make_mesh`` of the
cell's cards on its ``batch`` axis, the maps gathered on the first card.
It takes the costs the program builds from the settings alone (the
program refuses ``cost`` "mccnn" here)."""


def build(cfg, devices, root):
    from port_bench import system
    from stereo_match_tpu_torch.parallel.batch import batched_matcher
    from stereo_match_tpu_torch.parallel.mesh import make_mesh
    fn = batched_matcher(system.disparity_config(cfg),
                         make_mesh(batch=len(devices), devices=devices))
    return lambda ls, rs: fn(ls, rs)[0]
