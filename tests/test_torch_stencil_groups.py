"""The group table of the fused kernel's group design
(core/neighbors.group_table): the aligned 2×2×2 groups of a periodic
cube's blocks, each row the 4×4×4 blocks its tile's window is cut from and
its 8 output blocks, in the store's order. Held here against the
``(nb, 27)`` neighbour table it is built from; the tile's arithmetic is in
tests/test_torch_stencil_kernels.py, the kernel on the card in
chip_smoke.py."""

import itertools

import pytest
import torch

from repro_torch.core import neighbors as tnbr

KINDS = ("hilbert", "morton", "row_major", "column_major")
NTS = (2, 4, 8)
# the 2×2×2 offsets of a group's blocks, in the row's order
OWN = list(itertools.product(range(2), repeat=3))


def _table(kind, nt):
    return torch.from_numpy(tnbr.neighbor_table(kind, nt).copy())


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("kind", KINDS)
def test_every_block_is_an_output_of_one_group(kind, nt):
    groups = tnbr.group_table(_table(kind, nt))
    assert groups.dtype == torch.int32 and groups.is_contiguous()
    assert tuple(groups.shape) == (nt ** 3 // 8, tnbr.GROUP_COLS)
    own = groups[:, tnbr.GROUP_WINDOW:].flatten().sort().values
    assert torch.equal(own, torch.arange(nt ** 3, dtype=torch.int32))


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("kind", KINDS)
def test_group_rows_hold_the_tables_neighbourhood(kind, nt):
    """Window block (a, b, c) of a row is what the (nb, 27) table reaches
    from the group block nearest it, at the offset between the two; the
    group's blocks are the centre 2×2×2 of its window, in the same order,
    and lie at offsets (dk, di, dj) from the first."""
    nbr = _table(kind, nt)
    groups = tnbr.group_table(nbr)
    col = {o: tnbr.OFFSETS_FULL.index(o) for o in tnbr.OFFSETS_FULL}
    win = groups[:, :tnbr.GROUP_WINDOW].reshape(-1, 4, 4, 4)
    own = groups[:, tnbr.GROUP_WINDOW:].reshape(-1, 2, 2, 2)
    for r in range(groups.shape[0]):
        for dk, di, dj in OWN:
            assert own[r, dk, di, dj] == nbr[own[r, 0, 0, 0], col[(dk, di, dj)]]
            assert win[r, dk + 1, di + 1, dj + 1] == own[r, dk, di, dj]
        for a, b, c in itertools.product(range(4), repeat=3):
            near = tuple(min(max(x - 1, 0), 1) for x in (a, b, c))
            off = (a - 1 - near[0], b - 1 - near[1], c - 1 - near[2])
            assert win[r, a, b, c] == nbr[own[r][near], col[off]], (r, a, b, c)


@pytest.mark.parametrize("nt", NTS)
@pytest.mark.parametrize("kind", KINDS)
def test_group_rows_follow_the_store_order(kind, nt):
    """Row r is the group whose first block comes r-th along the store; on
    the hierarchical curves a group is eight consecutive blocks, so the
    tiles a thread block walks are neighbours in memory."""
    groups = tnbr.group_table(_table(kind, nt))
    own = groups[:, tnbr.GROUP_WINDOW:].long()
    first = own.min(dim=1).values
    assert bool((first[1:] > first[:-1]).all())
    if kind in ("hilbert", "morton"):
        want = torch.arange(nt ** 3).reshape(-1, 8)
        assert torch.equal(own.sort(dim=1).values, want)


@pytest.mark.parametrize("case", ["clamped", "mixed", "extended", "odd", "shuffled",
                                  "width"])
def test_group_table_is_none_off_an_even_periodic_cube(case):
    """Only a periodic cube's own table, of an even edge, groups."""
    if case == "clamped":
        nbr = torch.from_numpy(tnbr.neighbor_table("hilbert", 4, periodic=False).copy())
    elif case == "mixed":
        nbr = torch.from_numpy(tnbr.neighbor_table(
            "morton", 4, periodic=(True, False, True)).copy())
    elif case == "extended":  # the distributed path's core + shell table
        nbr = torch.from_numpy(tnbr.extended_neighbor_table("hilbert", 4).copy())
    elif case == "odd":
        nbr = _table("hilbert", 1)
    elif case == "shuffled":  # a column that no longer matches the walk
        nbr = _table("row_major", 4).clone()
        nbr[5, 0], nbr[6, 0] = nbr[6, 0].clone(), nbr[5, 0].clone()
    else:
        nbr = _table("hilbert", 4)[:, :26].contiguous()
    assert tnbr.group_table(nbr) is None


def test_group_table_device_is_built_once_per_table():
    """The launches' lookup: the same table tensor gives the same group
    table without building it again; one written in place is built anew."""
    nbr = _table("hilbert", 4)
    first = tnbr.group_table_device(nbr)
    assert tnbr.group_table_device(nbr) is first
    assert torch.equal(first, tnbr.group_table(nbr))
    other = tnbr.neighbor_table_device("morton", 4, device="cpu")
    assert torch.equal(tnbr.group_table_device(other), tnbr.group_table(other))
    nbr[0, 0] = nbr[0, 0]  # unchanged values, a new version
    again = tnbr.group_table_device(nbr)
    assert again is not first and torch.equal(again, first)
    bad = _table("hilbert", 4).clamp(max=0)
    assert tnbr.group_table_device(bad) is None
