"""The plain reference the benchmark holds the port against: float32
PyTorch with TF32 off, no kernel, importing nothing of the program
(``cfd`` the environment, ``ppo`` the policy and its update)."""
