"""``ops/pairwise.py::vote_share`` against a loop over walkers, warps,
steps and lanes that follows the pair kernels' schedule one lane at a
time (``csrc/pair_terms.cuh::walker_terms``)."""
import numpy as np
import pytest
import torch

from phd_qmclib_torch.models import mrbp
from phd_qmclib_torch.ops import pairwise

BENCH = mrbp.Spec(lattice_depth=20.0, lattice_ratio=1.0,
                  interaction_strength=1.0, boson_number=128,
                  supercell_size=128.0, tbf_contact_cutoff=0.4)


def _params(length, dtype, rm=0.4):
    """The bench model's packed vector with the supercell and the cutoff
    that the vote reads set to ``length`` and ``rm``."""
    params = pairwise.pack_params(BENCH.cfc_params, dtype, "cpu")
    params[pairwise.P_L], params[pairwise.P_RM] = length, rm
    return params


def _brute_vote_share(pos, params, nop):
    """Lane by lane: a (walker, warp, step) triple votes if some lane of
    the warp that takes a pair at that step has it inside the cutoff or
    coincident, in the positions' own precision."""
    pos = pos.numpy()
    table = params.numpy().reshape(-1, pairwise.PARAMS_SIZE)
    per_row = pos.shape[0] // table.shape[0]
    real = pos.dtype.type
    steps = (nop - 1) // 2
    schedule = [(k, nop) for k in range(1, steps + 1)]
    if nop % 2 == 0:
        schedule.append((nop // 2, nop // 2))
    votes = triples = 0
    for w, walker in enumerate(pos):
        row = table[w // per_row]
        length, rm = real(row[pairwise.P_L]), real(row[pairwise.P_RM])
        z = [x if real(0) <= x < length
             else real(x - length * np.floor(x / length)) for x in walker]
        for k, takers in schedule:
            for warp in range(-(-nop // 32)):
                lanes = [i for i in range(32 * warp, 32 * warp + 32)
                         if i < takers]
                if not lanes:
                    continue
                triples += 1
                hit = False
                for i in lanes:
                    ad = abs(real(z[i] - z[(i + k) % nop]))
                    r = real(length - ad) if ad > real(0.5) * length else ad
                    hit = hit or r < rm or r == 0
                votes += hit
    return votes / triples if triples else 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nop", [1, 2, 33, 64, 128])
def test_vote_share_matches_the_lane_by_lane_schedule(nop, dtype):
    # A density at which some warp steps vote and others do not.
    length = nop / 4
    pos = torch.as_tensor(np.random.default_rng(nop).uniform(
        0, length, (5, nop)), dtype=dtype)
    params = _params(length, dtype)
    got = pairwise.vote_share(pos, params, nop)
    assert got == _brute_vote_share(pos, params, nop)
    if nop >= 33:
        assert 0.0 < got < 1.0


def test_vote_share_of_a_table_takes_each_walkers_row():
    nop = 40
    table = torch.stack([_params(10.0, torch.float64),
                         _params(12.0, torch.float64, rm=0.05)])
    rng = np.random.default_rng(1)
    # Positions outside [0, L) too, wrapped as the kernels wrap them.
    pos = torch.as_tensor(rng.uniform(-10.0, 20.0, (6, nop)))
    got = pairwise.vote_share(pos, table, nop)
    assert got == _brute_vote_share(pos, table, nop)
    assert got != pairwise.vote_share(pos, table[0], nop)


@pytest.mark.parametrize("nop", [33, 64])
def test_vote_share_is_0_with_every_pair_outside(nop):
    """Evenly spaced particles 1 apart, further than rm = 0.4."""
    pos = torch.arange(nop, dtype=torch.float64).repeat(3, 1) + 0.25
    params = _params(nop, torch.float64)
    assert pairwise.vote_share(pos, params, nop) == 0.0
    assert _brute_vote_share(pos, params, nop) == 0.0


@pytest.mark.parametrize("nop", [33, 64])
def test_vote_share_is_1_with_every_pair_inside(nop):
    """A cutoff past L / 2: every pair is inside it."""
    pos = torch.as_tensor(np.random.default_rng(2).uniform(0, 8.0, (3, nop)))
    params = _params(8.0, torch.float64, rm=5.0)
    assert pairwise.vote_share(pos, params, nop) == 1.0
    assert _brute_vote_share(pos, params, nop) == 1.0


def test_vote_share_with_rm_0_counts_coincident_pairs():
    """With rm = 0 only coincident particles vote."""
    nop = 64
    pos = np.arange(nop, dtype=np.float64)[None].repeat(4, axis=0) + 0.5
    pos[1, 5] = pos[1, 6]
    pos[3, 40] = pos[3, 8]
    pos = torch.as_tensor(pos)
    params = _params(nop, torch.float64, rm=0.0)
    assert float(params[pairwise.P_RM]) == 0.0
    got = pairwise.vote_share(pos, params, nop)
    assert got == _brute_vote_share(pos, params, nop)
    # Each coincident pair votes in one warp at one step (the second at
    # the even last step) of 4 walkers x (31 steps x 2 warps + 1 warp).
    assert got == 2 / (4 * (31 * 2 + 1))
