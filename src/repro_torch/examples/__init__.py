"""The user-facing scripts, as modules of the package:
``python -m repro_torch.examples.drl_cylinder`` (training),
``...serve_batch`` (batched inference from a checkpoint) and
``...hybrid_scaling_demo`` (the parallel planner)."""
