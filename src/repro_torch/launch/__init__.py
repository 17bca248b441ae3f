"""Multi-process fleets: the bootstrap and heartbeats
(``launch.distributed``) and the elastic supervisor (``launch.fleet``)."""
