"""A closed loop: the next call goes in once the last call's maps are in
host memory.

Mix parameters: ``frames_per_call`` (B) and ``warmup_calls``. Call ``c``
takes pairs ``(c + i) % pool``, ``i < B``. A frame's latency is its call's
time, from the call with host arrays in hand to its maps on the host.
"""

import time


def warm_up(fn, pool, mix) -> None:
    for c in range(mix["warmup_calls"]):
        ls, rs, _ = pool.call(c, mix["frames_per_call"])
        fn(ls, rs).cpu()


def run(fn, pool, mix, seconds, window) -> None:
    B, c = mix["frames_per_call"], 0
    t0 = window.open()
    while True:
        ls, rs, pairs = pool.call(c, B)
        t_a = time.perf_counter()
        with window.entry():
            out = fn(ls, rs)
        with window.download():
            host = out.cpu().numpy()
        t_c = time.perf_counter()
        del out         # the next call may reuse the map's memory
        window.done(pairs, host, t_a, t_c)
        c += 1
        if t_c - t0 >= seconds:
            break
    window.close(t_c)
