"""Disparity-plane (D-axis) sharding and the plane-to-row re-shard.

Counterpart of ``stereo_match_tpu/parallel/dsharding.py``, in one process
over a ("disp",) device list (the port's idiom: one controller places each
shard's work with ``.to(device)``; ``torch.distributed`` is for processes).
Shard k owns the planes ``d0 = k * D / n`` .. ``d0 + D / n - 1``:

* **Cost construction + WTA** — each shard builds and searches only its
  D-slice, so the volume (238 MB at KITTI float32) never exists whole on
  one device. The slice is the census words of both views (K1) and K2 at
  ``min_disparity + d0`` over ``D / n`` planes: plane i of it costs
  ``cl[x]`` against ``cr[x - (min_disparity + d0 + i)]``, the invalid
  sentinel where ``x`` is smaller, which is what JAX's rolled and masked
  ``_local_census_volume`` computes. The WTA (:func:`wta_dsharded`) is
  JAX's ``pmin`` rounds in plain torch: each shard's (H, W) partial is
  moved to the first device of the axis, reduced with ``torch.minimum``
  and handed back to the shards that need it. Bit-equal to the
  single-device WTA.
* **SGM after a layout switch** — SGM's recurrence couples all d, so
  :func:`match_dsharded` re-shards the slices from planes to rows (JAX's
  ``all_to_all``: device j receives rows ``[j Hp / n, (j + 1) Hp / n)`` of
  every slice and concatenates them along D), runs K3 over the row blocks
  with their carry chains (``parallel/tiling.sgm_aggregate_blocks``), and
  K4 ``wta_lr`` on each block, where every d is present and the WTA, the
  right view and the disp12 check are row-local.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from stereo_match_tpu_torch.config import DisparityConfig
from stereo_match_tpu_torch.ops.cost_volume import (check_min_disparity,
                                                    volume_dtype)
from stereo_match_tpu_torch.ops.cuda_kernels import (WTA_BIG, census_volume,
                                                     census_words,
                                                     sgm_path_scan, wta_lr)
from stereo_match_tpu_torch.ops.wta import (disparity_from_stats,
                                            lr_consistency_mask)
from stereo_match_tpu_torch.parallel.mesh import (DeviceMesh, Split,
                                                  mesh_devices, named_mesh)
from stereo_match_tpu_torch.parallel.tiling import (check_modes,
                                                   sgm_aggregate_blocks)

BIG_INDEX = 2 ** 30   # an index no shard holds, as JAX's ``big_i``


def make_disp_mesh(n: int | None = None, devices=None) -> DeviceMesh:
    """A 1-axis ("disp",) mesh over the first ``n`` of ``devices`` (default:
    the visible CUDA cards, raising when there is none). A device may be
    listed several times (``["cuda:0"] * 4``); ``n`` beyond the list
    raises."""
    devs = mesh_devices(devices)
    if n is not None:
        if not 0 < n <= len(devs):
            raise ValueError(f"a disp axis of {n} over {len(devs)} devices")
        devs = devs[:n]
    return named_mesh(devs, (len(devs),), ("disp",))


def _disp_devices(mesh: DeviceMesh) -> list[torch.device]:
    return Split(mesh, "disp", 0).devices()


def _local_census_volume(left: torch.Tensor, right: torch.Tensor,
                         d_levels: int, d0: int, window: tuple[int, int],
                         min_disparity: int, dtype) -> torch.Tensor:
    """This shard's (D_loc, H, W) census-cost slice, planes d0..d0+D_loc-1:
    K1 on both (H, W) views, then K2 at ``min_disparity + d0``, on the
    views' device; bit-equal to JAX's ``_local_census_volume`` (float32,
    INVALID_COST; int16, INVALID_COST_I16)."""
    imgs = torch.stack([left, right]).to(torch.float32).contiguous()
    words = census_words(imgs, window)
    return census_volume(words[0], words[1], d_levels, min_disparity + d0,
                         dtype)


def _pmin(parts: list[torch.Tensor]) -> torch.Tensor:
    """``pmin`` over the shards: each (H, W) partial moved to the first
    shard's device and reduced there with ``torch.minimum``."""
    out = parts[0]
    for part in parts[1:]:
        out = torch.minimum(out, part.to(out.device))
    return out


def _cost_at(v: torch.Tensor, g: torch.Tensor, d0: int,
             big: float) -> torch.Tensor:
    """The cost at global plane index ``g`` (H, W) from this shard's float32
    slice ``v``; ``big`` where ``g`` is not one of its planes."""
    iota = torch.arange(v.shape[0], device=v.device)[:, None, None]
    return torch.where(iota == (g - d0)[None], v, big).amin(dim=0)


def _right_local(v: torch.Tensor, d0: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """This shard's right-view WTA: per (y, xr) the best cost and its
    *global* plane index over its planes, C_R(y, xr, d) = C_L(d, y, xr + d),
    3e9 where xr + d >= W; ties to the smallest d."""
    D_loc, H, W = v.shape
    v = v.to(torch.float32)
    sheared = torch.full_like(v, WTA_BIG)
    for i in range(D_loc):
        d = d0 + i
        if d < W:
            sheared[i, :, :W - d] = v[i, :, d:]
    best = sheared.amin(dim=0)
    d = d0 + torch.arange(D_loc, device=v.device,
                          dtype=torch.int32)[:, None, None]
    idx = torch.where(sheared == best[None], d, BIG_INDEX).amin(dim=0)
    return best, idx


def extract_disparity_dsharded(vol_locals: list[torch.Tensor],
                               min_disparity: int = 0,
                               uniqueness_ratio: int = 15,
                               disp12_max_diff: int = 1,
                               subpixel: bool = True) -> torch.Tensor:
    """WTA over a D-sharded volume: ``vol_locals`` are the shards' float32
    or int16 (D_k, H, W) slices in plane order, each on its device (the
    list stands for JAX's ``vol_local``, ``d0``, ``axis_name`` and
    ``num_disparities``). Returns the (H, W) float32 disparity, NaN
    invalid, on the first shard's device.

    ``ops/wta.extract_disparity``'s semantics in five (H, W) ``pmin``
    rounds: best, winner index (the first minimum: the least index among
    the shards whose best is the global best), c[idx - 1], c[idx + 1]
    (either may live on the neighbouring shard), the second best outside
    idx +- 1; and two for the right-view WTA of the disp12 check.
    """
    devices = [v.device for v in vol_locals]
    d0s = [0]
    for v in vol_locals[:-1]:
        d0s.append(d0s[-1] + v.shape[0])
    D = d0s[-1] + vol_locals[-1].shape[0]
    vs = [v.to(torch.float32) for v in vol_locals]

    best_l, idx_l, iotas = [], [], []
    for v, d0 in zip(vs, d0s):
        iota = d0 + torch.arange(v.shape[0], device=v.device,
                                 dtype=torch.int32)[:, None, None]
        b = v.amin(dim=0)
        best_l.append(b)
        idx_l.append(torch.where(v == b[None], iota, BIG_INDEX).amin(dim=0))
        iotas.append(iota)
    best = _pmin(best_l)
    ig = _pmin([torch.where(b == best.to(b.device), i, BIG_INDEX)
                for b, i in zip(best_l, idx_l)])
    igs = [ig.to(dev) for dev in devices]
    c0 = _pmin([_cost_at(v, g - 1, d0, WTA_BIG)
                for v, g, d0 in zip(vs, igs, d0s)])
    c2 = _pmin([_cost_at(v, g + 1, d0, WTA_BIG)
                for v, g, d0 in zip(vs, igs, d0s)])
    second = _pmin([torch.where((iota - g[None]).abs() <= 1, WTA_BIG, v)
                    .amin(dim=0) for v, g, iota in zip(vs, igs, iotas)])
    disp, mask = disparity_from_stats((best, ig, c0, c2, second), D,
                                      min_disparity, uniqueness_ratio,
                                      subpixel)
    if disp12_max_diff >= 0:
        right = [_right_local(v, d0) for v, d0 in zip(vs, d0s)]
        rb = _pmin([b for b, _ in right])
        ri = _pmin([torch.where(b == rb.to(b.device), i, BIG_INDEX)
                    for b, i in right])
        disp_right = (ri + min_disparity).to(torch.float32)
        mask = mask & lr_consistency_mask(disp, disp_right, disp12_max_diff,
                                          min_disparity)
    return torch.where(mask, disp, torch.nan)


def _shard_planes(D: int, n: int) -> int:
    if D % n:
        raise ValueError(f"num_disparities={D} not divisible by the disp "
                         f"axis size {n}")
    return D // n


def wta_dsharded(cost: torch.Tensor, mesh: DeviceMesh,
                 config: DisparityConfig | None = None) -> torch.Tensor:
    """D-shard a whole (D, H, W) volume over ``mesh``'s "disp" axis (shard
    k's planes copied to its device) and run the ``pmin``-combined WTA
    with ``config``'s min_disparity, uniqueness, disp12 and subpixel.
    Bit-equal to ``ops/wta.extract_disparity``; the map is returned on the
    first device of the axis."""
    cfg = config or DisparityConfig()
    devices = _disp_devices(mesh)
    cost = torch.as_tensor(cost)
    if cost.dtype not in (torch.float32, torch.int16):
        cost = cost.to(torch.float32)
    D_loc = _shard_planes(cost.shape[0], len(devices))
    parts = [cost[k * D_loc:(k + 1) * D_loc].contiguous().to(dev)
             for k, dev in enumerate(devices)]
    return extract_disparity_dsharded(parts, cfg.min_disparity,
                                      cfg.uniqueness_ratio,
                                      cfg.disp12_max_diff, cfg.subpixel)


def match_dsharded(left, right, config: DisparityConfig, mesh: DeviceMesh,
                   mode: str = "halo", halo: int = 48) -> torch.Tensor:
    """The D-sharded census matcher: per-shard cost slice (K1, K2) ->
    planes-to-rows re-shard -> row-sharded SGM (K3; ``mode`` "exact", the
    carry chains, or "halo", as ``parallel/tiling``) -> row-local WTA (K4
    ``wta_lr``) -> the rows joined on the first device of the axis.

    ``left``, ``right``: (H, W) images (arrays or tensors). ``config``'s
    census window, P1, P2, num_paths, dtype (float32 or int16) and WTA
    settings are read; its cost family and post stack are not (JAX's
    ``match_dsharded`` is census and returns the map before speckle and
    WLS). As in JAX, the images are padded with zero rows to ``Hp``, a
    multiple of ``n * 8`` (float32) or ``n * 16`` (int16) rows in exact
    mode and of ``n`` in halo mode, *before* the census, so below a padded
    height the last census rows see zero rows where the single-device
    matcher replicates the edge; the (H, W) float32 map, NaN invalid, is
    returned. Raises ValueError when num_disparities is not a multiple of
    the axis size.
    """
    cfg = config
    check_modes(cfg.num_paths, mode)
    check_min_disparity(cfg.min_disparity)
    dtype = volume_dtype(cfg.dtype)
    devices = _disp_devices(mesh)
    n = len(devices)
    D_loc = _shard_planes(cfg.num_disparities, n)
    left = torch.as_tensor(left, dtype=torch.float32)
    right = torch.as_tensor(right, dtype=torch.float32)
    H, W = left.shape
    unit = n * ((8 if dtype == torch.float32 else 16)
                if mode == "exact" else 1)
    Hp = -(-H // unit) * unit
    if Hp != H:
        left = F.pad(left, (0, 0, 0, Hp - H))
        right = F.pad(right, (0, 0, 0, Hp - H))

    slices = [_local_census_volume(left.to(dev), right.to(dev), D_loc,
                                   k * D_loc, cfg.census_window,
                                   cfg.min_disparity, dtype)
              for k, dev in enumerate(devices)]
    rows = Hp // n
    blocks = [torch.cat([s[:, j * rows:(j + 1) * rows].to(dev)
                         for s in slices], dim=0)
              for j, dev in enumerate(devices)]
    del slices
    totals = sgm_aggregate_blocks(blocks, cfg.P1, cfg.P2, cfg.num_paths,
                                  mode, halo, scan=sgm_path_scan)
    del blocks
    out = [wta_lr(t, cfg.min_disparity, cfg.uniqueness_ratio,
                  cfg.disp12_max_diff, cfg.subpixel)[0] for t in totals]
    return torch.cat([d.to(devices[0]) for d in out], dim=0)[:H]
