"""Test harness support of the port: the deterministic fault injector."""
