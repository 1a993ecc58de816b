"""Pipeline-stage parallelism: streaming video through a list of devices.

Counterpart of ``stereo_match_tpu/parallel/pipeline_stage.py``, in one
process. The single-card pass structure is cut into stages; stage ``i``
runs on device ``i`` of a ("stage",) mesh, frames enter at stage 0, and
each step every stage works on what the previous step handed it, then
hands its activation one stage on (``.to(next_device)``). With S stages, S
frames are in flight; on one card (a device list that repeats ``cuda:0``)
the stages run one after another.

Stage decomposition (the JAX package's):

====  =====================================================================
  0   census words (K1, one or more) -> (D, W, H) volume (K2, transposed)
      + horizontal forward scan (K3 along the volume's rows)
  1   horizontal reverse scan; transpose to the planes layout (D, H, W)
  2   vertical + diagonal downward scans (K3: S, SE, SW)
  3   upward scans (K3: N, NW, NE); WTA, uniqueness, subpixel, disp12
      (K4); speckle + WLS
====  =====================================================================

``n_stages=2`` fuses {0, 1} and {2, 3}. The activation (the payload) is
the float32 volume and running total (``payload_mode="volume"``), or the
running total and the census words of both views (``"census"``: stages 0
and 1 scan with the census-fused K10, stages 2 and 3 rebuild the volume
with K2 — about half the bytes per hop). Each frame's left image travels
with its activation, so stage S-1's WLS guides on its own frame.

The stage totals are integers (census costs, integral P1/P2, as the
headline config has), so the outputs equal ``pipeline.stereo._match_core``
on each frame bit for bit, though the stages add the directions in
another order. ``payload_dtype="int16"`` casts the payload to int16 at
each hop only (every stage computes in float32) and clamps the x < d
sentinel from 1e4 to 1024 so that it fits; its outputs equal a float32
run with ``_invalid_clamp=1024`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops.cost_volume import (INVALID_COST,
                                                    INVALID_COST_I16)
from stereo_match_tpu_torch.ops.cuda_kernels import (census_scan,
                                                     census_volume,
                                                     census_words,
                                                     n_census_words,
                                                     sgm_path_scan, wta_lr)
from stereo_match_tpu_torch.ops.sgm import PATH_DIRECTIONS_8
from stereo_match_tpu_torch.ops.speckle import speckle_filter
from stereo_match_tpu_torch.ops.wls import wls_filter_disparity
from stereo_match_tpu_torch.parallel.mesh import (DeviceMesh, Split,
                                                  mesh_devices)
from stereo_match_tpu_torch.pipeline.stereo import check_slice

DOWN = tuple(d for d in PATH_DIRECTIONS_8 if d[0] > 0)   # S, SE, SW
UP = tuple(d for d in PATH_DIRECTIONS_8 if d[0] < 0)     # N, NW, NE


def _check_stages(cfg: DisparityConfig, n_stages: int) -> None:
    if cfg.cost != "census" or cfg.num_paths != 8 or cfg.min_disparity < 0:
        raise ValueError("stage pipeline supports the production fast path: "
                         "census cost, 8-path SGM, min_disparity >= 0")
    if n_stages not in (2, 4):
        raise ValueError("n_stages must be 2 or 4")
    check_slice(cfg)


def _words(left: torch.Tensor, right: torch.Tensor, window) -> torch.Tensor:
    """(2, nw, H, W) int32 census words of both views (K1)."""
    return census_words(torch.stack([left, right]).contiguous(), window)


def _scan_all(vol, tot, directions, cfg):
    for dy, dx in directions:
        sgm_path_scan(vol, tot, dy, dx, cfg.P1, cfg.P2, accumulate=True)


def _post(tot: torch.Tensor, left: torch.Tensor,
          cfg: DisparityConfig) -> torch.Tensor:
    """Final total -> (2, H, W) [raw, filtered]: K4, speckle, WLS."""
    disp, _ = wta_lr(tot, cfg.min_disparity, cfg.uniqueness_ratio,
                     cfg.disp12_max_diff, cfg.subpixel)
    disp = speckle_filter(disp, cfg.speckle_window_size, cfg.speckle_range)
    filt = wls_filter_disparity(disp, left, cfg.lmbda, cfg.sigma,
                                cfg.wls_iters) if cfg.wls else disp
    return torch.stack([disp, filt])


def _compose(units):
    """Fuse stage units pairwise into a 2-stage split."""
    def fuse(f, g):
        def h(*args):
            *state, _ = f(*args)
            return g(*state, *args[-2:])
        return h
    return [fuse(units[0], units[1]), fuse(units[2], units[3])]


def make_stage_fns(cfg: DisparityConfig, image_shape: tuple[int, int],
                   n_stages: int, invalid_clamp: float | None = None):
    """The volume-payload stages: ``(payload, left, right) -> (payload,
    out)``.

    ``payload`` is the (volume, total) pair, float32; (D, W, H) between
    stages 0 and 1, (D, H, W) after; None into stage 0. ``out`` is the
    (2, H, W) [raw, filtered] disparity from the last stage, else None.
    ``right`` is read by stage 0 only. ``invalid_clamp`` clamps the built
    volume to that value: the 1e4 sentinel at x < d becomes e.g. 1024, so
    path totals stay inside int16 on the wire (census costs are below it).
    """
    _check_stages(cfg, n_stages)
    D = cfg.num_disparities

    def build_hfwd(payload, left, right):
        wT = _words(left, right, cfg.census_window).transpose(2, 3)
        wT = wT.contiguous()                                 # (2, nw, W, H)
        volT = census_volume(wT[0], wT[1], D, cfg.min_disparity,
                             transposed=True)
        if invalid_clamp is not None:
            volT.clamp_(max=invalid_clamp)
        totT = torch.empty_like(volT)
        sgm_path_scan(volT, totT, 1, 0, cfg.P1, cfg.P2, accumulate=False)
        return (volT, totT), None

    def hrev_transpose(payload, left, right):
        volT, totT = payload
        sgm_path_scan(volT, totT, -1, 0, cfg.P1, cfg.P2, accumulate=True)
        return (volT.transpose(1, 2).contiguous(),
                totT.transpose(1, 2).contiguous()), None

    def scan3_fwd(payload, left, right):
        _scan_all(*payload, DOWN, cfg)
        return payload, None

    def scan3_rev_post(payload, left, right):
        vol, tot = payload
        _scan_all(vol, tot, UP, cfg)
        return payload, _post(tot, left, cfg)

    units = [build_hfwd, hrev_transpose, scan3_fwd, scan3_rev_post]
    return units if n_stages == 4 else _compose(units)


def make_stage_fns_census(cfg: DisparityConfig, image_shape: tuple[int, int],
                          n_stages: int, invalid_clamp: float | None = None):
    """The census-payload stages: ``(tot, words, left, right) -> (tot,
    words, out)``.

    The volume is a function of the census words, so instead of handing it
    on, each stage rebuilds what it needs: stages 0 and 1 run the
    census-fused horizontal scans (K10, no volume at all), stages 2 and 3
    rebuild the planes-layout volume (K2). ``tot``: (D, H, W) float32;
    ``words``: (2, 1, H, W) int32 (both views); both None into stage 0.
    ``invalid_clamp`` is the x < d sentinel of the scans and the clamp of
    the rebuilt volumes.
    """
    _check_stages(cfg, n_stages)
    wh, ww = cfg.census_window
    if wh * ww - 1 > 24:
        raise ValueError("census payload mode needs <= 24-bit census "
                         "words (window area - 1 <= 24)")
    H, W = image_shape
    D = cfg.num_disparities
    invalid = INVALID_COST if invalid_clamp is None else float(invalid_clamp)
    scan_kw = dict(min_disparity=cfg.min_disparity, p1=cfg.P1, p2=cfg.P2,
                   invalid_cost=invalid)

    def rebuild_vol(words):
        vol = census_volume(words[0], words[1], D, cfg.min_disparity)
        if invalid_clamp is not None:
            vol.clamp_(max=invalid_clamp)
        return vol

    def s0(tot, words, left, right):
        words = _words(left, right, cfg.census_window)
        tot = torch.empty((D, H, W), dtype=torch.float32, device=left.device)
        census_scan(words[0], words[1], tot, reverse=False, accumulate=False,
                    **scan_kw)
        return tot, words, None

    def s1(tot, words, left, right):
        census_scan(words[0], words[1], tot, reverse=True, accumulate=True,
                    **scan_kw)
        return tot, words, None

    def s2(tot, words, left, right):
        _scan_all(rebuild_vol(words), tot, DOWN, cfg)
        return tot, words, None

    def s3(tot, words, left, right):
        _scan_all(rebuild_vol(words), tot, UP, cfg)
        return tot, words, _post(tot, left, cfg)

    units = [s0, s1, s2, s3]
    return units if n_stages == 4 else _compose(units)


class StreamingPipeline:
    """Stage pipeline over a ("stage",) mesh, one stage per device.

    >>> mesh = make_stage_mesh(4, devices=["cuda:0"] * 4)
    >>> pipe = StreamingPipeline(cfg, mesh, image_shape=(H, W))
    >>> results = pipe.run(frames)          # [(raw, filtered), ...]

    Frame t's disparity emerges ``n_stages - 1`` steps after it is fed;
    :meth:`run` handles the fill and flush. The in-flight activations stay
    on their stages' devices between steps; results are (H, W) float32
    tensors on the last stage's device.

    ``payload_dtype="int16"`` halves the bytes of each hop (census costs
    with integral P1/P2); ``payload_mode="census"`` hands on (total, census
    words) instead of (volume, total). ``_invalid_clamp`` is a test hook:
    a float32 run with the int16 mode's sentinel.
    """

    def __init__(self, config: DisparityConfig, mesh: DeviceMesh,
                 image_shape: tuple[int, int], axis: str = "stage",
                 payload_dtype: str = "float32",
                 payload_mode: str = "volume",
                 _invalid_clamp: float | None = None):
        if payload_dtype not in ("float32", "int16"):
            raise ValueError("payload_dtype must be float32 or int16")
        if payload_mode not in ("volume", "census"):
            raise ValueError("payload_mode must be volume or census")
        self.config = config
        self.mesh = mesh
        self.axis = axis
        self.n_stages = mesh.shape[axis]
        self.devices = Split(mesh, axis, 0).devices()
        invalid_clamp = _invalid_clamp
        if payload_dtype == "int16":
            # int16 hops are exact only for bounded integer totals: the
            # sentinel drops from 1e4 to 1024, and the totals in flight
            # (2 paths at the 2-stage hop, 5 after stage 2 of 4) must stay
            # below 2^15
            if config.cost != "census" or \
                    config.P1 != int(config.P1) or config.P2 != int(config.P2):
                raise ValueError("int16 payload needs census cost and "
                                 "integral P1/P2")
            paths_in_flight = 2 if self.n_stages == 2 else 5
            bound = paths_in_flight * (INVALID_COST_I16 + config.P2)
            if bound >= 2 ** 15:
                raise ValueError(
                    f"int16 payload would overflow on the wire: "
                    f"paths_in_flight*(1024+P2)={bound:.0f} >= 32768; "
                    f"lower p2 or use payload_dtype='float32'")
            invalid_clamp = float(INVALID_COST_I16)
        self.image_shape = tuple(image_shape)
        self.payload_mode = payload_mode
        make = make_stage_fns_census if payload_mode == "census" \
            else make_stage_fns
        self._stages = make(config, self.image_shape, self.n_stages,
                            invalid_clamp=invalid_clamp)
        self._wire = torch.int16 if payload_dtype == "int16" \
            else torch.float32
        self.reset()

    def wire_bytes(self) -> int:
        """Bytes of the payload one hop hands on (the left image aside)."""
        H, W = self.image_shape
        plane = self.config.num_disparities * H * W * self._wire.itemsize
        if self.payload_mode == "census":
            words = n_census_words(self.config.census_window)
            return plane + 2 * words * H * W * 4
        return 2 * plane

    def reset(self) -> None:
        """Clear all in-flight activations (:meth:`run` calls it, so one
        pipeline can stream several independent sequences)."""
        self._state = [None] * self.n_stages   # payload arriving at stage i
        self._left = [None] * self.n_stages    # the frame's left image
        self._fed = 0

    def _run_stage(self, i, payload, left, right):
        """Stage i on its payload (float32 again after an int16 hop)."""
        if self.payload_mode == "census":
            tot, words = payload if payload is not None else (None, None)
            if tot is not None:
                tot = tot.to(torch.float32)
            tot, words, out = self._stages[i](tot, words, left, right)
            return (tot, words), out
        if payload is not None:
            payload = tuple(p.to(torch.float32) for p in payload)
        return self._stages[i](payload, left, right)

    def _hop(self, payload, device):
        """Cast the payload to the wire type and move it to ``device``."""
        if self.payload_mode == "census":
            tot, words = payload
            return tot.to(device, self._wire), words.to(device)
        return tuple(p.to(device, self._wire) for p in payload)

    def _advance(self, frame):
        """One step: each stage runs on what it holds, then hands it on.

        ``frame`` is the (left, right) pair for stage 0, or None (flush).
        Returns the last stage's output, None while it holds nothing.
        """
        S = self.n_stages
        state, lefts = [None] * S, [None] * S
        out = None
        for i in range(S):
            if i == 0:
                if frame is None:
                    continue
                (left, right), payload = frame, None
            else:
                payload, left, right = self._state[i], self._left[i], None
                if payload is None:
                    continue
            payload, stage_out = self._run_stage(i, payload, left, right)
            if i < S - 1:
                state[i + 1] = self._hop(payload, self.devices[i + 1])
                lefts[i + 1] = left.to(self.devices[i + 1])
            else:
                out = stage_out
        self._state, self._left = state, lefts
        return out

    def step(self, left, right) -> torch.Tensor | None:
        """Feed one frame pair; returns the (2, H, W) [raw, filtered]
        disparity of the frame fed ``n_stages - 1`` steps ago, or None
        while the pipeline is still filling."""
        dev = self.devices[0]
        frame = (torch.as_tensor(left, dtype=torch.float32, device=dev),
                 torch.as_tensor(right, dtype=torch.float32, device=dev))
        out = self._advance(frame)
        self._fed += 1
        return out if self._fed >= self.n_stages else None

    def run(self, frames) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Stream ``frames`` (iterable of (left, right)) through the
        pipeline; returns [(raw, filtered)] per frame, in order. Resets
        first, so back-to-back runs are independent."""
        self.reset()
        results = []
        for left, right in frames:
            out = self.step(left, right)
            if out is not None:
                results.append((out[0], out[1]))
        for _ in range(self.n_stages - 1):      # flush
            out = self._advance(None)
            if out is not None:
                results.append((out[0], out[1]))
        return results


def make_stage_mesh(n_stages: int, devices=None) -> DeviceMesh:
    """A 1-axis ("stage",) mesh over the first ``n_stages`` devices
    listed (default: the visible CUDA cards; too few raises)."""
    devs = mesh_devices(devices)
    if len(devs) < n_stages:
        raise ValueError(f"{n_stages} stages need {n_stages} devices; "
                         f"{len(devs)} listed")
    arr = np.empty(n_stages, dtype=object)
    arr[:] = devs[:n_stages]
    return DeviceMesh(arr, ("stage",))
