"""The system under test: ``stereo_match_tpu_torch`` behind the entry a
traffic mix names.

A mix's ``entry`` names ``entries/<entry>.py``, whose
``build(cfg, devices, root)`` returns ``fn(lefts, rights)``: the raw
disparity maps of a call's frames as one ``(frames, H, W)`` tensor, still
on the card, for ``(frames, H, W)`` host arrays; the harness brings it to
the host. A configuration whose cost needs a provider object (``cost``
"mccnn") has ``providers/<cost>.py`` with ``build(cfg, dc, device,
root)``; the program builds the others from the matching settings alone.
"""

from __future__ import annotations

from dataclasses import fields
from pathlib import Path

from port_bench import manifest


def disparity_config(cfg: dict):
    """The program's ``DisparityConfig`` from every key of ``cfg`` that
    names one of its fields (lists become tuples); the rest of ``cfg``
    (frame size, source, weights) is the benchmark's."""
    from stereo_match_tpu_torch.config import DisparityConfig
    kw = {f.name: cfg[f.name] for f in fields(DisparityConfig)
          if f.name in cfg}
    return DisparityConfig(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in kw.items()})


def cost_fn(cfg: dict, dc, device, root: Path):
    """``providers/<cost>.py``'s provider on ``device``, or None."""
    path = root / manifest.HERE.name / "providers" / f"{cfg['cost']}.py"
    if not path.is_file():
        return None
    return manifest.module(path).build(cfg, dc, device, root)


def build(cfg: dict, traffic: dict, devices: list, root: Path):
    """``entries/<traffic["entry"]>.py``'s ``fn`` for ``cfg`` on
    ``devices``."""
    path = root / manifest.HERE.name / "entries" / f"{traffic['entry']}.py"
    if not path.is_file():
        raise ValueError(f"unknown entry {traffic['entry']!r}: no {path}")
    return manifest.module(path).build(cfg, devices, root)
