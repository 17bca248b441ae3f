"""The benchmark of the PyTorch and CUDA port (``repro_torch``): PPO
training of an active-flow-control agent against a batch of
incompressible-flow environments on one card, in env-steps per second.

Run one cell from the root of a checkout::

    python3 -m afcbench.run --workload cyl_re100.res16.envs32 --seed 7 \\
        --seconds 30 --trace 0

``BENCHMARK.json`` at the root names the cells, configurations, traffic
mixes and metrics; each lives in a file of its own under this package
(``configs/``, ``traffic/``, ``metrics/``), found by its name.
"""
