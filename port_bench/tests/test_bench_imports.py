"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either. Top-level names (before the first
dot) are compared whole: the program's name begins with the JAX
package's."""

import json
import subprocess
import sys

from port_bench import manifest

SPY = """
import json, sys, time
sys.path.insert(0, {root!r})
seen = set()

class Spy:
    def find_spec(self, name, path=None, target=None):
        seen.add(name.split(".")[0])
        return None

sys.meta_path.insert(0, Spy())
{body}
seen |= {{m.split(".")[0] for m in sys.modules}}
print(json.dumps(sorted(seen)))
"""

HARNESS = """
from port_bench.core import run_cell
import port_bench.run, port_bench.calibrate
for cell in ("census_kitti.seq", "mccnn_acc_kitti.seq"):
    out = run_cell(cell, 5, 0.2, True, time.perf_counter(), on_card=False,
                   size=(24, 48, 16), log=lambda _: None)
    assert out["correct"], out
"""

REFERENCE = """
import numpy as np
from port_bench.reference import disparity_maps
rng = np.random.default_rng(0)
l = rng.integers(0, 256, (1, 12, 40)).astype(np.uint8)
r = np.roll(l, -3, axis=2)
cfg = {"cost": "census", "num_disparities": 8, "min_disparity": 0,
       "census_window": [5, 5], "num_paths": 8, "p1": None, "p2": None,
       "uniqueness_ratio": 15, "disp12_max_diff": 1, "subpixel": True}
disparity_maps(l, r, cfg, "cpu")
disparity_maps(l, r, dict(cfg, cost="mccnn", scale=24.0), "cpu",
               precision="tf32",
               weights=WEIGHTS)
"""


def loaded(body: str) -> set[str]:
    code = SPY.format(root=str(manifest.ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    seen = loaded(HARNESS)
    assert "stereo_match_tpu_torch" in seen      # the spy sees imports
    assert not seen & {"jax", "jaxlib", "flax", "stereo_match_tpu"}


def test_reference_loads_nothing_of_either_package():
    weights = str(manifest.ROOT /
                  "stereo_match_tpu/models/weights/mccnn_accurate.npz")
    seen = loaded(REFERENCE.replace("WEIGHTS", repr(weights)))
    assert "torch" in seen
    assert not seen & {"jax", "jaxlib", "flax", "stereo_match_tpu",
                       "stereo_match_tpu_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from port_bench.run import forbidden_modules
    fake = {"stereo_match_tpu_torch": 1, "stereo_match_tpu_torch.ops": 1,
            "jaxtyping": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert forbidden_modules() == []
    fake["stereo_match_tpu.models"] = 1
    fake["jax"] = 1
    assert forbidden_modules() == ["jax", "stereo_match_tpu.models"]
