"""The paper's CFD <-> DRL data interface (``core.interface``) and its
parallel planner (``core.plan``, ``core.scaling_model``, ``core.autotune``)."""
