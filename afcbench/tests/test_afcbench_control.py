"""The comparison's control and faults: the reference in the program's
place in the lower precision, and each fault the cells can have planted
underneath the timed path, must come out not correct.  On the CPU at a
tiny size here; at the cells' own sizes on the card (``cuda``), where
``python3 -m afcbench.readings`` gives the readings the limits are set
from."""
import time

import pytest
import torch

from afcbench import bench, cells, check, faults, program
from afcbench.tests.test_afcbench_harness import _tiny

CELLS = ["cyl_re100.res16.envs32", "pinball_re100.res16.envs32",
         "cyl_re100.res48.envs4"]


def _record(cell, seed, device, plant=None):
    cfg, mix = cell.config, cell.traffic
    env, st, obs = program.build_env(cfg, mix, device)
    prog = program.build_program(env, st, obs, cfg, mix, seed, device)
    inputs = program.Inputs(seed, int(mix["n_envs"]),
                            env.cfg.actions_per_episode, prog.act_dim,
                            prog.ppo_cfg.epochs, device)
    if plant is None:
        return bench.setup_episodes(prog, inputs, seed)
    with plant():
        return bench.setup_episodes(prog, inputs, seed)


@pytest.mark.parametrize("name", ["cyl_re100.res16.envs32",
                                  "pinball_re100.res16.envs32"])
def test_the_control_is_not_correct(name):
    cell = _tiny(cells.load_cell(name))
    rec = _record(cell, 5, torch.device("cpu"))
    sound = check.compare(rec, cell.config, cell.traffic, "cpu")
    assert check.judge(sound, cell.limits)[0], sound
    found = check.compare(rec, cell.config, cell.traffic, "cpu",
                          control=True)
    assert not check.judge(found, cell.limits)[0], found


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_each_fault_makes_the_run_not_correct(fault):
    """The whole run but the look for a card, the timed path broken
    underneath by the fault."""
    cell = _tiny(cells.load_cell("cyl_re100.res16.envs32"))
    with faults.FAULTS[fault]():
        res = bench.run(cell, 2 ** 31 + 7, 0.2, False, "cpu",
                        time.perf_counter())
    assert not res["correct"], res["compared"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells' own sizes run the "
                    "hand-written kernels, which have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_at_the_cells_size(name, cuda):
    """On the card at the cell's own size: a sound seed is correct, the
    control and every fault are not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load_cell(name)
    cfg, mix = cell.config, cell.traffic
    rec = _record(cell, 17, cuda)
    assert check.judge(check.compare(rec, cfg, mix, cuda), cell.limits)[0]
    control = check.compare(rec, cfg, mix, cuda, control=True)
    assert not check.judge(control, cell.limits)[0], control
    del rec
    for fault in faults.FAULTS.values():
        rec = _record(cell, 17, cuda, fault)
        found = check.compare(rec, cfg, mix, cuda)
        assert not check.judge(found, cell.limits)[0], found
