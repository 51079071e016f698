"""The server fold's launch plan and its aligned row windows, on the CPU.

``kernels/server_update/kernel.py :: fold_plan`` sizes the fold kernel's
launch (column tile, rows a ring stage, stages, grid, shared bytes) and
``row_window`` is the kernel's rule for the bytes of a plane row that a
bulk copy may read (``csrc/server_update.cu`` mirrors both).  Checked here
for every C, P and itemsize of the grid below:

* the tiles cover every column exactly once, and the grid's persistent
  blocks walk every tile exactly once (the grid is never larger than the
  number of tiles);
* a block's shared memory, window padding included, stays within the
  card's opt-in limit and holds every row's window;
* the row groups cover rows 0..C-1 in ascending order;
* a byte-level replay of the windows, on planes whose base is 0-15 bytes
  past a 16-byte boundary and whose P is ragged, rebuilds
  ``plane[c, j0:j0 + n]`` exactly in each row's slot and reads no byte
  outside the plane.
"""
import numpy as np
import pytest

from repro_torch.kernels.server_update import kernel as su_kernel
from repro_torch.kernels.server_update.kernel import (
    BLOCKS_PER_SM, MAX_STAGES, MAX_TILE, fold_plan, row_window, slot_bytes, smem_bytes,
    weights_bytes)

SMS, LIMIT = 132, 232_448  # H100 SXM: SMs, opt-in shared bytes a block
CS = (1, 2, 25, 100, 1000, 5000)
PS = (1, 15, 16, 17, 22_026, 11_173_962)
ITEMSIZES = (1, 2, 4)
GRID = [(i, P) for i in ITEMSIZES for P in PS]


def _plans(itemsize, P):
    return [(C, fold_plan(C, P, itemsize, SMS, LIMIT)) for C in CS]


@pytest.mark.parametrize("itemsize,P", GRID)
def test_plan_covers_every_column_once(itemsize, P):
    for C, plan in _plans(itemsize, P):
        assert plan.tile % 16 == 0 and 16 <= plan.tile <= MAX_TILE
        assert plan.tiles == -(-P // plan.tile)
        assert (plan.tiles - 1) * plan.tile < P <= plan.tiles * plan.tile
        # block b walks tiles b, b + grid, ...: each tile once, all blocks busy
        walked = [len(range(b, plan.tiles, plan.grid)) for b in range(plan.grid)]
        assert sum(walked) == plan.tiles and min(walked) >= 1
        widths = [min(plan.tile, P - t * plan.tile) for t in range(min(plan.tiles, 4))]
        assert all(n > 0 for n in widths)
        last = P - (plan.tiles - 1) * plan.tile
        assert 0 < last <= plan.tile
        assert (plan.tiles - 1) * plan.tile + last == P, (C, plan)


@pytest.mark.parametrize("itemsize,P", GRID)
def test_plan_grid_never_exceeds_tiles(itemsize, P):
    for C, plan in _plans(itemsize, P):
        assert 1 <= plan.grid <= plan.tiles, (C, plan)
        assert plan.grid <= SMS * BLOCKS_PER_SM  # every block resident at once


@pytest.mark.parametrize("itemsize,P", GRID)
def test_plan_stage_bytes_fit_the_opt_in_limit(itemsize, P):
    for C, plan in _plans(itemsize, P):
        slot = slot_bytes(plan.tile, itemsize)
        assert plan.smem_bytes == smem_bytes(plan.tile, plan.rows, plan.stages, itemsize)
        assert plan.smem_bytes <= LIMIT, (C, plan)
        assert 1 <= plan.stages <= MAX_STAGES
        # every slot of the ring, and the ring itself, starts 16-byte aligned
        assert slot % 16 == 0 and (8 * plan.tile + weights_bytes(plan.rows)) % 16 == 0
        assert weights_bytes(plan.rows) >= 2 * 2 * 4 * plan.rows  # wn and scale, two items
        # a row's 16-byte aligned window, padding included, fits its slot
        for offset in range(16):
            w0, _, _ = row_window(offset, offset + plan.tile * itemsize, 0, 1 << 62)
            w1 = (offset + plan.tile * itemsize + 15) & ~15
            assert w1 - w0 <= slot


@pytest.mark.parametrize("itemsize,P", GRID)
def test_plan_row_groups_ascend_over_every_row(itemsize, P):
    for C, plan in _plans(itemsize, P):
        assert plan.groups == -(-C // plan.rows) and 1 <= plan.rows <= C
        rows = [c for g in range(plan.groups)
                for c in range(g * plan.rows, min(C, (g + 1) * plan.rows))]
        assert rows == list(range(C)), (C, plan)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_main_plane_is_one_wave_of_single_stage_tiles(itemsize):
    """The main path's (25, 22026): 126 tiles of 176 columns for 132 SMs,
    all 25 rows in one stage, so each block stages its tile once."""
    plan = fold_plan(25, 22_026, itemsize, SMS, LIMIT)
    assert (plan.tile, plan.tiles, plan.grid, plan.rows, plan.groups, plan.stages) == (
        176, 126, 126, 25, 1, 1)


@pytest.mark.parametrize("itemsize", ITEMSIZES)
def test_large_plane_tiles_are_wide_and_fill_the_card(itemsize):
    """At a ResNet-18 sized plane each bulk copy moves a full-width row
    segment (4 KB, or the widest tile for int8), every SM holds a block,
    and the ring keeps stages in flight."""
    plan = fold_plan(25, 11_173_962, itemsize, SMS, LIMIT)
    assert plan.tile == min(MAX_TILE, su_kernel.ROW_BYTES // itemsize)
    assert plan.tile * itemsize >= 2048
    assert plan.grid >= SMS and plan.stages >= 2


def _replay(buf, base, C, P, itemsize, plan):
    """Stage every row segment of every tile as the kernel does and return
    (rebuilt, touched): ``rebuilt[t][c]`` the segment's bytes read back
    from its slot, ``touched`` every byte address read."""
    end = base + C * P * itemsize
    base16, end16 = (base + 15) & ~15, end & ~15
    slot = slot_bytes(plan.tile, itemsize)
    touched, rebuilt = set(), []
    for t in range(plan.tiles):
        j0 = t * plan.tile
        n = min(plan.tile, P - j0)
        rows = []
        for c in range(C):
            a = base + (c * P + j0) * itemsize
            b = a + n * itemsize
            w0, lo, hi = row_window(a, b, base16, end16)
            room = np.zeros(slot, dtype=np.uint8)
            ordinary = []
            if hi > lo:
                assert lo % 16 == 0 and hi % 16 == 0  # a legal bulk copy
                assert hi - w0 <= slot
                room[lo - w0:hi - w0] = buf[lo:hi]
                touched.update(range(lo, hi))
                ordinary += [range(a, min(b, lo)), range(max(a, hi), b)]
            else:
                ordinary.append(range(a, b))
            for r in ordinary:
                assert len(r) < 16 or (hi <= lo and len(r) < 32)
                for q in r:
                    room[q - w0] = buf[q]
                touched.update(r)
            rows.append(room[a - w0:b - w0].copy())
        rebuilt.append(rows)
    return rebuilt, touched


OFFSETS = [(i, off) for i in ITEMSIZES for off in range(0, 16, i)]


@pytest.mark.parametrize("itemsize,offset", OFFSETS)
def test_row_windows_rebuild_the_plane_and_read_only_the_plane(itemsize, offset):
    rng = np.random.default_rng(offset * 7 + itemsize)
    for C, P in ((1, 1), (3, 15), (2, 17), (7, 37), (5, 100), (4, 1000)):
        nbytes = C * P * itemsize
        base = 64 + offset  # the plane's data_ptr, offset bytes past a 16-byte boundary
        buf = rng.integers(0, 256, size=base + nbytes + 64, dtype=np.uint8)
        plane = buf[base:base + nbytes].reshape(C, P * itemsize)
        plan = fold_plan(C, P, itemsize, 4, LIMIT)  # 4 SMs: several tiles a plane
        rebuilt, touched = _replay(buf, base, C, P, itemsize, plan)
        assert min(touched) >= base and max(touched) < base + nbytes, (C, P)
        for t, rows in enumerate(rebuilt):
            j0 = t * plan.tile * itemsize
            for c, got in enumerate(rows):
                np.testing.assert_array_equal(got, plane[c, j0:j0 + len(got)])
                assert len(got) == min(plan.tile, P - t * plan.tile) * itemsize


def test_device_plan_uses_the_cards_limits(monkeypatch):
    su_kernel.device_plan.cache_clear()
    monkeypatch.setattr(su_kernel, "_device_limits", lambda device: (SMS, LIMIT))
    try:
        assert su_kernel.device_plan(25, 22_026, 4, 0) == fold_plan(25, 22_026, 4, SMS, LIMIT)
    finally:
        su_kernel.device_plan.cache_clear()
