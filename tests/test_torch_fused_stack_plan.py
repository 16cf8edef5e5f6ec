"""The plan of the fused-stack kernels K1 and K2, checked on the CPU.

``ops/cuda/fused_stack_plan.py`` mirrors what ``csrc/fused_stack_common.cuh``
fixes at compile time (tile, regions, shared-memory buffers, the weight
ring's chunks, the warps' units). The CUDA kernel runs only on a card; these
tests hold the mirror to what the kernel relies on, and the mirror to the
header's constants. ``chip_smoke.py`` and tests/test_torch_cuda.py hold the
compiled kernel's own report to the mirror on the card.
"""
import os
import re

import numpy as np
import pytest
import torch

from fs_uae_image_enhancer_project_tpu_torch.models import get_model
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack as fs
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_packed as k2
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import build
from fs_uae_image_enhancer_project_tpu_torch.ops.cuda import fused_stack_plan as plan
from fs_uae_image_enhancer_project_tpu_torch.scripts import profile_fused_stack, sweep_fused_stack

HEADER = os.path.join(os.path.dirname(plan.__file__), "csrc", "fused_stack_common.cuh")
# the shipped tile, the first design's, and others a sweep may build
TILES = [plan.TILE, (16, 16), (14, 16), (12, 20), (20, 12), (16, 12)]


def _params():
    return get_model("pix_shuffle").init(torch.Generator().manual_seed(0), device="cpu")


def test_mirror_matches_the_header():
    src = open(HEADER).read()

    def num(pattern):
        return int(re.search(pattern, src).group(1))

    assert (num(r"#define FSE_TILE_H (\d+)"), num(r"#define FSE_TILE_W (\d+)")) == plan.TILE
    assert num(r"constexpr int NWARPS = (\d+);") == plan.NWARPS
    assert num(r"constexpr int NT_GROUP = (\d+);") == plan.NT_GROUP
    assert num(r"constexpr int SMEM_LIMIT = (\d+);") == plan.SMEM_LIMIT
    assert num(r"P_TOTAL = (\d+);") == plan.PARAM_FLOATS == fs.PARAM_TOTAL
    assert (num(r"constexpr int PROFILE_CTAS = (\d+),"), num(r"PROFILE_STAMPS = (\d+);")) == (
        profile_fused_stack.PROFILE_CTAS, profile_fused_stack.PROFILE_STAMPS)
    for pk, (s_in, s36, s72) in plan.STRIDES.items():
        m = re.search(rf"struct Geo<{pk}> {{ static constexpr int CS_IN = (\d+), CS36 = (\d+), "
                      rf"CS72 = (\d+); }};", src)
        assert tuple(int(v) for v in m.groups()) == (s_in, s36, s72)


@pytest.mark.parametrize("pk", [1, 2])
@pytest.mark.parametrize("tile", TILES)
def test_shared_memory_fits_and_buffers_keep_apart(pk, tile):
    """At most 232,448 bytes a CTA; the buffers that live together do not
    overlap, and each layer's ring is apart from what the layer reads and
    writes; l1 whole fits where its window and the later ring go."""
    sm = plan.smem(pk, tile)
    assert plan.smem_bytes(pk, tile) <= plan.SMEM_LIMIT == 232_448
    assert all(off % 16 == 0 and n > 0 for off, n in sm.values())

    def apart(a, b):
        (oa, na), (ob, nb) = sm[a], sm[b]
        return oa + na <= ob or ob + nb <= oa

    for layer, live in plan.LIVE.items():
        ring = plan.ring_name(layer)
        for name in live:
            assert apart(ring, name), (layer, ring, name)
        for i, a in enumerate(live):
            for b in live[i + 1:]:
                assert apart(a, b), (layer, a, b)
    a_off, a_n = sm["A"]
    assert sm["A1C"][0] == a_off and sm["ring3"][0] == a_off + sm["A1C"][1]
    assert sm["ring3"][0] + sm["ring3"][1] >= a_off + a_n
    assert sm["P"][0] + sm["P"][1] == plan.smem_bytes(pk, tile)


@pytest.mark.parametrize("pk", [1, 2])
@pytest.mark.parametrize("tile", TILES)
def test_ring_chunks_sum_to_each_layers_fragment_array(pk, tile):
    """The chunks run over every k-step once, in order; their bytes sum to the
    layer's B-fragment array as the wrapper lays it out; each fits its half
    of the ring (or the ring, for a layer staged whole)."""
    sw = (fs if pk == 1 else k2).prepare_weights(_params(), "cpu")
    ring = plan.smem(pk, tile)
    for ly, frag in zip(plan.layers(pk), sw.frags):
        chunks = plan.ring_chunks(pk, ly.out, tile)
        ring_bytes = ring[plan.ring_name(ly.out)][1]
        slice_bytes = ly.nt * plan.SLICE_BYTES_PER_NTILE
        assert [k for k0, n, _ in chunks for k in range(k0, k0 + n)] == list(range(ly.ks))
        assert sum(n * slice_bytes for _, n, _ in chunks) == frag.numel() * 2 == ly.weight_bytes
        if len(chunks) == 1:
            assert ly.weight_bytes <= ring_bytes
        else:
            kc = chunks[0][1]
            assert 2 * kc * slice_bytes <= ring_bytes
            assert [off for *_, off in chunks] == [(c % 2) * kc * slice_bytes
                                                   for c in range(len(chunks))]


@pytest.mark.parametrize("pk", [1, 2])
@pytest.mark.parametrize("tile", [plan.TILE, (16, 16)])
def test_units_cover_every_mtile_and_ngroup_once(pk, tile):
    """Per layer, the warps' units are every (m-tile, n-group) once, with at
    most 108 accumulators a thread (the registers 12 warps leave hold them),
    and a warp keeps one n-group (so each B fragment it reads serves all of
    its m-tiles)."""
    for ly in plan.layers(pk):
        nrows, mtiles, ng, ntc = plan.geometry(pk, ly.out, tile)
        per_warp = plan.units(pk, ly.out, tile)
        flat = sorted(u for w in per_warp for u in w)
        assert flat == [(m, g) for m in range(mtiles) for g in range(ng)]
        assert ng * ntc == ly.nt and ntc <= plan.NT_GROUP
        assert max(len(w) for w in per_warp) * ntc * 4 <= 108
        for w, us in enumerate(per_warp):
            assert all(g == w % ng for _, g in us)
        assert (mtiles - 1) * 16 < nrows <= mtiles * 16


@pytest.mark.parametrize("pk", [1, 2])
@pytest.mark.parametrize("h2,w2", [(288, 376), (290, 375), (17, 33), (1, 1)])
def test_every_output_pixel_is_written_once(pk, h2, w2):
    """Layer 7's units over the grid of tiles write each pixel of the frame
    exactly once (a matmul row is pk pixels; rows past the region and pixels
    outside the frame are not written)."""
    tile = plan.TILE
    count = np.zeros((h2, w2), np.int64)
    gx, gy = plan.grid(h2, w2, tile)
    nrows, _, _, _ = plan.geometry(pk, 7, tile)
    rows = [r for w in plan.units(pk, 7, tile) for m, g in w if g == 0
            for r in range(16 * m, 16 * m + 16) if r < nrows]
    ys, xs = [], []
    for r in rows:
        y, x = plan.row_pixels(pk, 7, r, tile)
        for px in range(pk):
            ys.append(y)
            xs.append(x + px)
    ys, xs = np.array(ys), np.array(xs)
    for by in range(gy):
        for bx in range(gx):
            iy, ix = by * tile[0] + ys, bx * tile[1] + xs
            keep = (iy < h2) & (ix < w2)
            np.add.at(count, (iy[keep], ix[keep]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("pk", [1, 2])
@pytest.mark.parametrize("tile", [plan.TILE, (16, 16), (12, 20)])
def test_l1_window_holds_what_layer_6_reads(pk, tile):
    """Layer 6 reads l1 through the window of layer 5's region, 4 pixels in
    from l1's edges: every pixel its windows (3 rows x pk+2 columns a matmul
    row, rows past the region clamped) touch lies in that window, and the
    window lies in l1's region."""
    r1, c1 = plan.region(1, tile)
    r5, c5 = plan.region(5, tile)
    d = (7 - 1) - (7 - 5)
    assert d + r5 <= r1 and d + c5 <= c1
    nrows, _, _, _ = plan.geometry(pk, 6, tile)
    for r in range(nrows):
        y, x = plan.row_pixels(pk, 6, r, tile)
        for dy in range(3):
            for dx in range(pk + 2):
                # layer 6's window offset into a source of layer 5's geometry is 0
                sy, sx = y + dy, x + dx
                assert 0 <= sy < r5 and 0 <= sx < c5, (r, dy, dx)
                assert 0 <= sy + d < r1 and 0 <= sx + d < c1


@pytest.mark.parametrize("pk", [1, 2])
def test_every_layer_reads_inside_its_source_region(pk):
    """Each layer's windows (rows clamped to the region's last row) stay in
    the region of its source, so no read crosses into another buffer."""
    tile = plan.TILE
    for ly in plan.layers(pk):
        nrows, mtiles, _, _ = plan.geometry(pk, ly.out, tile)
        rs, cs = plan.region(ly.geo, tile)
        off = (7 - ly.geo) - (7 - ly.out) - 1
        for r in range(mtiles * 16):
            y, x = plan.row_pixels(pk, ly.out, min(r, nrows - 1), tile)
            assert 0 <= y + off and y + off + 2 < rs
            assert 0 <= x + off and x + off + pk + 1 < cs


def test_weight_bytes_a_cta_reads():
    """Each layer's weights once a CTA: K1's 0.31 MB and K2's 0.77 MB."""
    assert plan.weight_bytes_per_cta(1) == 310_272
    assert plan.weight_bytes_per_cta(2) == 769_536
    assert plan.waves(288, 376, plan.TILE) == pytest.approx(486 / 132)


def test_first_design_read_each_layers_weights_once_a_warp_job():
    """The sweep's count of the weight bytes a CTA of the first design read:
    each of a layer's m-tiles (16x16 tile) read the whole fragment array."""
    assert sweep_fused_stack.parent_weight_bytes_per_cta(1) == 9_376_512
    assert sweep_fused_stack.parent_weight_bytes_per_cta(2) == 12_003_840


def test_profile_phases_run_from_start_to_end_and_add_up():
    """The profile's phases follow each other from stamp 0 to stamp 16, so
    they add up to the tile's time; CTAs without a whole record are left
    out."""
    chain = [a for _, a, _ in profile_fused_stack.PHASES] + [16]
    assert chain[0] == 0 and all(b == chain[i + 1]
                                 for i, (_, _, b) in enumerate(profile_fused_stack.PHASES))
    order = [0, 2, 3, 4, 5, 17, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
    assert chain == order
    rng = np.random.default_rng(0)
    stamps = np.zeros((8, profile_fused_stack.PROFILE_STAMPS), np.uint64)
    for c in range(6):  # two CTAs recorded nothing
        t = 1000 + np.cumsum(rng.integers(1, 500, len(order)))
        stamps[c, order] = t
    got = profile_fused_stack.phases(stamps)
    assert got["ctas"] == 6
    parts = sum(v for k, v in got.items() if k not in ("total", "ctas"))
    assert parts == pytest.approx(got["total"])
    with pytest.raises(ValueError):
        profile_fused_stack.phases(np.zeros_like(stamps))


def test_variant_libraries_build_apart():
    """A tile sweep's defines and another source tree each get their own
    library path; the package's own is the default."""
    base = build.library_path()
    assert build.library_path(build.CSRC, ()) == base
    assert build.library_path(build.CSRC, ("FSE_TILE_W=16",)) != base
    assert build.library_path(build.CSRC, ("FSE_PROFILE",)) not in (
        base, build.library_path(build.CSRC, ("FSE_TILE_W=16",)))


@pytest.mark.parametrize("script", [sweep_fused_stack, profile_fused_stack])
def test_card_scripts_refuse_to_run_without_a_card(script, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert script.main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err
