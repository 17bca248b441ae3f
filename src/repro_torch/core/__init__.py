"""The paper's CFD <-> DRL data interface (``core.interface``)."""
