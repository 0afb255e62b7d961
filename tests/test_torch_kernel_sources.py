"""Host-side pieces of the port's CUDA kernels that run without a card: the
spin-timeout record's names and report (`kernels/_build.py`), the sources'
one timeout policy, and K20's tensor-map planes against the plain layout
of its ring buffers (`kernels/sp_ag_attention.py`)."""

import ctypes
import re

import pytest
import torch

from triton_distributed_tpu_torch.kernels import _build
from triton_distributed_tpu_torch.kernels import sp_ag_attention as sp

SOURCES = sorted(_build.CSRC.glob("*.cu")) + sorted(_build.CSRC.glob("*.cuh"))


def test_spin_waits_name_every_wait_of_the_sources():
    """Every `WAIT_*` the kernels pass is an entry of `enum Wait`, ids run
    from 0 in order, names are distinct, and every entry is used."""
    waits = _build.spin_waits()
    assert sorted(waits) == list(range(len(waits)))
    enums = [e for e, _ in waits.values()]
    names = [n for _, n in waits.values()]
    assert len(set(enums)) == len(enums) and len(set(names)) == len(names)
    assert waits[0][0] == "WAIT_NONE"
    used = set()
    for src in SOURCES:
        text = src.read_text()
        if src.name == "common.cuh":
            text = text[text.index("};", text.index("enum Wait")):]
        used |= set(re.findall(r"\bWAIT_[A-Z0-9_]+\b", text))
    assert used <= set(enums), used - set(enums)
    assert set(enums) - used == {"WAIT_NONE"}


def test_sources_hold_one_timeout_policy():
    """No source prints from a kernel or keeps a second report switch:
    every wait goes through `spin_timeout` (a function call in a kernel
    makes ptxas serialize its `wgmma`s)."""
    for src in SOURCES:
        text = src.read_text()
        assert "TDT_SPIN_REPORT" not in text, src.name
        assert not re.search(r"\bprintf\s*\(", text), src.name
        assert "const char* what" not in text, src.name
    common = (_build.CSRC / "common.cuh").read_text()
    assert common.count("__trap()") == 1


@pytest.mark.parametrize("what,want", [
    (0, None),
    (1, "an mbarrier phase (TMA or bulk copies) (WAIT_MBARRIER)"),
    (None, "sp_ag_attention ring arrival (TMA loads) "
           "(WAIT_SP_AG_RING_LOAD)"),
])
def test_spin_report_reads_the_record(monkeypatch, what, want):
    """`spin_report` names the wait of a filled record, None for an empty
    one (a record in host memory, as the card's trap leaves it)."""
    ids = {e: i for i, (e, _) in _build.spin_waits().items()}
    rec = _build._SpinRecord()
    rec.what = ids["WAIT_SP_AG_RING_LOAD"] if what is None else what
    rec.block[:] = [3, 1, 0]
    rec.thread = 256
    rec.addr, rec.want, rec.seen = 0x7F00, 12, 9
    monkeypatch.setattr(_build, "_spin_record", rec)
    got = _build.spin_report()
    if want is None:
        assert got is None
    else:
        assert got == (f"a wait timed out: {want}; block (3, 1, 0) thread "
                       "256 waited at 0x7f00 for 12, which held 9")
    assert ctypes.sizeof(_build._SpinRecord) == 48


@pytest.mark.parametrize("world,b,h,hkv,s_loc,d", [
    (2, 1, 4, 1, 24, 64), (4, 2, 8, 2, 200, 128), (8, 1, 32, 8, 5, 128)])
def test_ring_planes_match_the_buffer_layout(world, b, h, hkv, s_loc, d):
    """A ring buffer (W, B, Hkv, S_loc, D) seen as K20's tensor map (D,
    S_loc, W B Hkv): plane `ring_plane(c, bi, hk)` holds chunk c's rows of
    (bi, hk); the stacked inputs and queries read the same way."""
    maps = sp.ring_maps(world, b, h, hkv, s_loc, d)
    buf = torch.arange(world * b * hkv * s_loc * d).reshape(
        world, b, hkv, s_loc, d)
    d0, rows, planes = maps["ring"]
    assert maps["kv"] == maps["ring"]
    planed = buf.reshape(planes, rows, d0)
    seen = set()
    for c in range(world):
        for bi in range(b):
            for hk in range(hkv):
                plane = sp.ring_plane(c, bi, hk, b, hkv)
                assert torch.equal(planed[plane], buf[c, bi, hk])
                seen.add(plane)
    assert seen == set(range(planes))
    q = torch.arange(world * b * h * s_loc * d).reshape(
        world, b, h, s_loc, d)
    qd0, qrows, qplanes = maps["q"]
    flat = q.reshape(qplanes, qrows, qd0)
    for r, bi, hh in ((0, 0, 0), (world - 1, b - 1, h - 1)):
        assert torch.equal(flat[(r * b + bi) * h + hh], q[r, bi, hh])
