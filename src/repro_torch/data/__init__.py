"""Data paths: the sharded trajectory dataset and the synthetic LM stream."""
