"""Checkpoints of the port: crash-atomic file I/O (``io``) and the
checkpoint format, directory layout and background writer
(``checkpoint``)."""
