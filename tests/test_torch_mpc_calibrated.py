"""K2-K5's plain linearization and host harnesses (``tests/
test_torch_mpc_batch.py``) on the calibrated fleet's narrowest and widest
chains: ``robotiq_2f_85`` (one revolute finger joint: K2's three seeds in
one thread, 30 of K3's 32 lanes idle) and the Jaco's 8-joint chain.

The tests are those of ``test_torch_mpc_batch.py``, run here on these two
robots so that their cost falls on another worker (the suite distributes by
file): the linearization against ``jax.jacfwd`` (f64 1e-9; f32 1e-4 on the
rows of q' and 1e-3 on those of dq', the Jaco's held to each row's scale:
its finger weighs grams, so dq' reaches dt M^-1 ~ 43) and ``torch.func.
jacfwd``; K3's warp phases bitwise against the emitted one-thread sweep,
with a NaN scenario (the unit's sqrtf PyTorch's, as the plain version's);
K2's thread body for G in {1, 3, n} bitwise against the plain
linearization and the one-seed body, on a limit and with a NaN scenario;
K4's body keeping every alpha's trajectory.
"""

import pytest

from test_torch_mpc_batch import (  # noqa: F401  (fixtures)
    CALIBRATED,
    CALIBRATED_ARMS,
    LIN_CASES,
    LIN_SHAPES,
    TEAM_REGS,
    TEAM_SHAPES,
    arm_pairs,
    fwd_units,
    lin_units,
    team_units,
)
from test_torch_mpc_batch import test_bwd_team_keeps_a_nan_scenario_to_itself as _bwd_nan
from test_torch_mpc_batch import test_bwd_team_phases_match_emitted_step_bitwise as _bwd_team
from test_torch_mpc_batch import test_lin_group_body_halves_the_tangent_on_a_limit as _lin_limit
from test_torch_mpc_batch import test_lin_group_body_keeps_a_nan_scenario_to_itself as _lin_nan
from test_torch_mpc_batch import test_lin_group_body_matches_plain_bitwise as _lin_group
from test_torch_mpc_batch import test_linearize_plain_matches_jax_jacfwd as _lin_jax
from test_torch_mpc_batch import test_linearize_plain_matches_torch_jacfwd as _lin_torch
from test_torch_mpc_batch import test_linesearch_body_keeps_every_alphas_trajectory_bitwise as _linesearch

ROBOTS = sorted(CALIBRATED)


@pytest.fixture(scope="module")
def arms():
    return arm_pairs(CALIBRATED_ARMS)


@pytest.mark.parametrize("robot", ROBOTS)
@pytest.mark.parametrize("case", sorted(LIN_CASES))
def test_linearize_plain_matches_jax_jacfwd(arms, robot, case):
    _lin_jax(arms, robot, case)


@pytest.mark.parametrize("robot", ROBOTS)
def test_linearize_plain_matches_torch_jacfwd(arms, robot):
    _lin_torch(arms, robot)


@pytest.mark.parametrize("reg", TEAM_REGS)
@pytest.mark.parametrize("B, H", TEAM_SHAPES)
@pytest.mark.parametrize("robot", ROBOTS)
def test_bwd_team_phases_match_emitted_step_bitwise(team_units, robot, B, H, reg):
    _bwd_team(team_units, robot, B, H, reg)


@pytest.mark.parametrize("robot", ROBOTS)
def test_bwd_team_keeps_a_nan_scenario_to_itself(team_units, robot):
    _bwd_nan(team_units, robot)


@pytest.mark.parametrize("B, H", LIN_SHAPES)
@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_lin_group_body_matches_plain_bitwise(lin_units, robot, which, B, H):
    _lin_group(lin_units, robot, which, B, H)


@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_lin_group_body_halves_the_tangent_on_a_limit(lin_units, robot, which):
    _lin_limit(lin_units, robot, which)


@pytest.mark.parametrize("which", ["1", "3", "n"])
@pytest.mark.parametrize("robot", ROBOTS)
def test_lin_group_body_keeps_a_nan_scenario_to_itself(lin_units, robot, which):
    _lin_nan(lin_units, robot, which)


@pytest.mark.parametrize("B, H, A", [(3, 4, 6), (33, 2, 1), (5, 3, 7)])
@pytest.mark.parametrize("robot", ROBOTS)
def test_linesearch_body_keeps_every_alphas_trajectory_bitwise(fwd_units, robot, B, H, A):
    _linesearch(fwd_units, robot, B, H, A)
