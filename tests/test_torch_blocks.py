"""Port block plan (``repro_torch.core.blocks``) against the JAX
package's ``BlockPlan``: identical unit layout and transfer arithmetic
over a (z, ndiv, bt) grid."""

import pytest

from repro.core.blocks import BlockPlan as JPlan
from repro_torch.core.blocks import BlockPlan as TPlan

GRID = [
    (1152, 8, 12), (1152, 8, 1), (96, 4, 2), (96, 2, 4), (96, 8, 1),
    (64, 2, 4), (240, 3, 5), (100, 1, 3),
]


@pytest.mark.parametrize("z,ndiv,bt", GRID)
def test_plan_equal(z, ndiv, bt):
    t, j = TPlan(z, ndiv, bt), JPlan(z, ndiv, bt)
    t.check_cover()
    assert (t.block, t.halo) == (j.block, j.halo)
    assert t.units() == j.units()
    for i in range(ndiv):
        assert t.owned(i) == j.owned(i)
        assert t.fetch(i) == j.fetch(i)
        assert t.remainder(i) == j.remainder(i)
        assert t.fetch_units(i) == j.fetch_units(i)
        assert t.writeback_units(i) == j.writeback_units(i)
        assert t.d2h_planes(i) == j.d2h_planes(i)
        for shared in (True, False):
            assert t.h2d_planes(i, shared) == j.h2d_planes(i, shared)
    for i in range(ndiv - 1):
        assert t.common(i) == j.common(i)


def test_paper_plan_sizes():
    plan = TPlan(1152, 8, 12)
    assert plan.halo == 48 and plan.block + 2 * plan.halo == 240
    assert plan.h2d_planes(3, shared=False) - plan.h2d_planes(3) == 96


def test_too_wide_halo_rejected():
    with pytest.raises(AssertionError):
        TPlan(96, 8, 2)  # block 12 < 2H = 16
