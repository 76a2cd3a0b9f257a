"""Kernel 1's route decision (``ops/fused_block_cuda.choose_route``), on the
CPU: a pure function of the launch's positions U and slots A, the staged
route's position limit on the card (``max_positions(A)``, 563 at A = 32 on
an H100), the warp route's rows ``WARP_ROWS_MAX`` and the wide route's
widest A on the card (``wide_max_slots()``, 9,852 on an H100).  Each
boundary is held from both sides: A = 32/33, the warp route's widest A and
one past it, the wide route's widest and one past it, U at the staged limit
and one past it.  The kernels themselves are held to the plain version on
the card (chip_smoke.py phase 3, tests/test_torch_cuda.py).
"""

import pytest
import torch

from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

LIMIT = 563  # max_positions(32) on an H100
WIDE_LIMIT = 9852  # wide_max_slots() on an H100
WIDEST = 32 * fbc.WARP_ROWS_MAX


@pytest.mark.parametrize("U, A, want", [
    (LIMIT, 32, "staged"),
    (LIMIT + 1, 32, "warp"),
    (1, 1, "staged"),
    (LIMIT + 1, 1, "warp"),
    (1, 33, "warp"),
    (8, 33, "warp"),
    (128, 56, "warp"),
    (128, 104, "warp"),
    (10_000, 104, "warp"),
    (1, WIDEST, "warp"),
    (10_000, WIDEST, "warp"),
    (1, WIDEST + 1, "wide"),
    (1, WIDEST + 8, "wide"),
    (10_000, WIDEST + 1, "wide"),
    (128, 304, "wide"),
    (128, 1000, "wide"),
    (1, WIDE_LIMIT, "wide"),
    (10_000, WIDE_LIMIT, "wide"),
    (1, WIDE_LIMIT + 1, "general"),
    (10_000, WIDE_LIMIT + 1, "general"),
    (4, 16_000, "general"),
])
def test_choose_route_at_each_boundary(U, A, want):
    assert fbc.choose_route(U, A, LIMIT, WIDE_LIMIT) == want


@pytest.mark.parametrize("A", [1, 13, 24, 32])
def test_staged_limit_decides_only_up_to_32_slots(A):
    """At A <= 32 the staged limit alone decides; past 32 slots it is not
    consulted, whatever it is."""
    assert fbc.choose_route(100, A, 100, WIDE_LIMIT) == "staged"
    assert fbc.choose_route(101, A, 100, WIDE_LIMIT) == "warp"
    assert fbc.choose_route(1, 33, 10**9, WIDE_LIMIT) == "warp"


@pytest.mark.parametrize("A", [WIDEST + 1, 304, 1000])
def test_wide_limit_decides_only_past_the_warp_route(A):
    """Past the warp route's widest A the wide limit alone decides, at any U
    and whatever the staged limit; up to it the wide limit is not
    consulted."""
    assert fbc.choose_route(1, A, 10**9, A) == "wide"
    assert fbc.choose_route(1, A, 10**9, A - 1) == "general"
    assert fbc.choose_route(10**6, WIDEST, 0, 0) == "warp"


def test_route_counters_and_named_launches():
    """The wrapper counts every launch, and the warp, wide and general
    routes' apart; a launch names one of the four routes, and a CPU tensor
    goes to the plain version without launching or counting."""
    assert fbc.ROUTES == ("staged", "warp", "wide", "general")
    counters = ("launches", "warp_launches", "wide_launches", "general_launches")
    assert all(getattr(fbc, name) >= 0 for name in counters)
    gen = torch.Generator().manual_seed(0)
    D, U, A, M = 3, 4, 40, 1
    cv = torch.randint(1, 9, (D, U, A), generator=gen).to(torch.float32)
    f = torch.ones((U, D))
    u = torch.rand((M, U, D), generator=gen)
    z0 = torch.zeros((U, D), dtype=torch.int32)
    nkg = torch.full((A, D), 100.0)
    valid = torch.ones((A, D))
    ndk0 = torch.zeros((A, D))
    ndk0[0] = float(U)
    args = (cv, f, u, z0, nkg, valid, ndk0, 0.1, 0.01)
    before = [getattr(fbc, name) for name in counters]
    z, ndk = fbc.fused_block(*args)
    assert [getattr(fbc, name) for name in counters] == before
    want = fbc.fused_block_torch(*args)
    assert torch.equal(z, want[0]) and torch.equal(ndk, want[1])
    with pytest.raises(ValueError, match="no route"):
        fbc._launch("cta", *args)
    for kernel in ("warp", "wide"):
        with pytest.raises(ValueError, match="CUDA device"):
            fbc._launch(kernel, *args)
    assert [getattr(fbc, name) for name in counters] == before
