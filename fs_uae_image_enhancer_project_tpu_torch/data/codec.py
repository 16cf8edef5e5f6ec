"""Generated-dataset filename codec.

The dataset generator encodes every sample's full parameter spec in its
filename; training re-parses them to pair styled inputs with targets. One
codec serves both sides here — the reference keeps two independent copies
(dataset_generator/generator.py:38-64 construct_filename and
model/srdataset.py:14-135 parse_generated_filename) which this module
unifies, with identical wire format:

    target:  target_<crop_x>_<crop_y>_s<scale>_r<rot>.png
    styled:  <resolution>_<crop_x>_<crop_y>_s<scale>_r<rot>_rgb<rgb>_p<pal>_d<dither>.png

e.g. ``lores_-16_32_s70_r20_rgb444_p32_dfloyd-steinberg.png``.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

TARGET_RE = re.compile(
    r"^target_(?P<crop_x>-?\d+)_(?P<crop_y>-?\d+)"
    r"_s(?P<scale_perc>\d+)_r(?P<rot_deg>-?\d+)$"
)
STYLED_RE = re.compile(
    r"^(?P<resolution>\w+?)_(?P<crop_x>-?\d+)_(?P<crop_y>-?\d+)"
    r"_s(?P<scale_perc>\d+)_r(?P<rot_deg>-?\d+)_(?P<style_name>.+)$"
)
STYLE_PARAMS_RE = re.compile(
    r"^rgb(?P<rgb_val>\d+)_p(?P<pal_str>\w+)_d(?P<dither_name>[\w-]+)$"
)




def _scale_part(scale_perc: int) -> str:
    """Canonical scale group token: 0 and 100 both mean no downscale."""
    return "s0" if scale_perc in (0, 100) else f"s{scale_perc}"


def construct_filename(params: Dict[str, Any], is_target: bool) -> str:
    """Build a sample filename from its parameter dict.

    Mirrors reference generator.py:38-64, including 'None' palette encoding.
    """
    for k in ("crop_x", "crop_y", "scale_perc", "rot_deg"):
        if k not in params:
            raise ValueError(
                "Missing mandatory crop/pre-processing parameters for filename construction."
            )
    # scale is canonicalized exactly like dither below: 0 and 100 both mean
    # no downscale, spelled s0 on the wire (the reference's spelling; this
    # repo's round-2 corpora used s100) — callers re-emitting parsed legacy
    # params get the canonical name without a special case
    stem = (
        f"{params['crop_x']}_{params['crop_y']}"
        f"_{_scale_part(params['scale_perc'])}_r{params['rot_deg']}"
    )
    if is_target:
        return f"target_{stem}.png"
    for k in ("resolution", "rgb", "pal", "dither"):
        if k not in params:
            raise ValueError("Missing mandatory style parameters for filename construction.")
    pal_str = str(params["pal"]) if params["pal"] is not None else "None"
    rgb = params["rgb"]
    rgb_num = rgb[3:] if isinstance(rgb, str) and rgb.upper().startswith("RGB") else rgb
    # no-dither is spelled 'None' on the wire (the reference's spec space
    # carries the capitalized string into construct_filename; its parser
    # normalizes case back — srdataset.py:342)
    dither = params["dither"]
    dither_str = "None" if str(dither).lower() == "none" else str(dither)
    return f"{params['resolution']}_{stem}_rgb{rgb_num}_p{pal_str}_d{dither_str}.png"


def parse_generated_filename(filename: str) -> Optional[Dict[str, Any]]:
    """Parse a sample filename back into its parameter dict.

    Returns None for non-matching files (reference srdataset.py:14-135
    semantics, including the RGB<k> string form and lowercase dither names).
    """
    name, ext = os.path.splitext(filename)
    if ext.lower() != ".png":
        return None

    m = TARGET_RE.match(name)
    if m:
        d = m.groupdict()
        return {
            "type": "target",
            "crop_x": int(d["crop_x"]),
            "crop_y": int(d["crop_y"]),
            "scale_perc": int(d["scale_perc"]),
            "rot_deg": int(d["rot_deg"]),
            "style_name": None,
            # canonical: s0 and s100 are the same no-downscale operation
            # (reference spelling s0; this repo historically wrote s100);
            # grouping by scale_part must unite them or legacy targets
            # never pair with newly generated styled files
            "scale_part": _scale_part(int(d["scale_perc"])),
            "rot_part": f"r{int(d['rot_deg'])}",
            "resolution": None,
            "rgb": None,
            "pal": None,
            "dither": None,
            "filename": filename,
        }

    m = STYLED_RE.match(name)
    if not m:
        return None
    d = m.groupdict()
    sp = STYLE_PARAMS_RE.match(d["style_name"])
    if not sp:
        return None
    s = sp.groupdict()
    # Malformed numeric tokens (e.g. ``_pXYZ_``) skip the file rather than
    # crash the gatherer — reference srdataset.py catches ValueError and
    # returns None.
    try:
        pal = None if s["pal_str"].lower() == "none" else int(s["pal_str"])
        rgb = f"RGB{int(s['rgb_val'])}"
    except ValueError:
        return None
    return {
        "type": "style",
        "crop_x": int(d["crop_x"]),
        "crop_y": int(d["crop_y"]),
        "scale_perc": int(d["scale_perc"]),
        "rot_deg": int(d["rot_deg"]),
        "resolution": d["resolution"],
        "style_name": d["style_name"],
        "rgb": rgb,
        "pal": pal,
        "dither": s["dither_name"].lower(),
        "scale_part": _scale_part(int(d["scale_perc"])),
        "rot_part": f"r{int(d['rot_deg'])}",
        "filename": filename,
    }
